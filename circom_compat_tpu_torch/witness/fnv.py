"""FNV-1a 64-bit hash of signal names — circom's WASM input-signal addressing
(reference: src/witness/mod.rs:13-19)."""

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
_M64 = 0xFFFFFFFFFFFFFFFF


def fnv1a_64(name: str) -> int:
    h = FNV_OFFSET
    for byte in name.encode("utf-8"):
        h = ((h ^ byte) * FNV_PRIME) & _M64
    return h


def fnv(name: str):
    """Return the (msb_u32, lsb_u32) split circom's setInputSignal expects."""
    h = fnv1a_64(name)
    return (h >> 32) & 0xFFFFFFFF, h & 0xFFFFFFFF
