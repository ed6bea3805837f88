"""Command-line interface: snarkjs-compatible witness/prove/verify flows.

  python -m circom_compat_tpu_torch witness <circuit.wasm> <input.json> <out.wtns>
  python -m circom_compat_tpu_torch prove   <circuit.zkey> <witness.wtns> \
                                            <proof.json> <public.json> [--device cpu] \
                                            [--backend device|streamed]
  python -m circom_compat_tpu_torch fullprove <input.json> <circuit.wasm> <circuit.zkey> \
                                            <proof.json> <public.json> [--device cpu] \
                                            [--backend device|streamed]
  python -m circom_compat_tpu_torch verify  <verification_key.json> <public.json> <proof.json>
  python -m circom_compat_tpu_torch export-vkey <circuit.zkey> <verification_key.json>
  python -m circom_compat_tpu_torch export-calldata <public.json> <proof.json>
  python -m circom_compat_tpu_torch r1cs-info <circuit.r1cs>
  python -m circom_compat_tpu_torch setup   <circuit.r1cs> <out.zkey> [vk.json] [--device cpu]
  python -m circom_compat_tpu_torch contribute <in.zkey> <out.zkey> [--name N] [--entropy E] \
                                            [--device cpu]
  python -m circom_compat_tpu_torch verify-chain <circuit.zkey>
  python -m circom_compat_tpu_torch verify-onchain <verification_key.json|circuit.zkey> \
                                            <public.json> <proof.json> [--artifact A]
  python -m circom_compat_tpu_torch serve   <circuit.zkey> [--wasm W] [--socket S] [--device cpu]
  python -m circom_compat_tpu_torch prove-client [--witness W | --inputs I] [--socket S]
  python -m circom_compat_tpu_torch dist-dryrun [--processes N] [--local-devices M] \
                                            [--chain-k K] [--two-level] [--timeout S] \
                                            [--device cpu] [--backend nccl|gloo]

Commands that prove, set up or contribute run on the card unless --device names another
device (--device cpu: every kernel wrapper's plain version); without a card
the default raises. --backend streamed keeps the key's query sections on the
host and sends them to the device in chunks (models/streamed.py), for keys
larger than the card's memory. dist-dryrun proves a squaring chain in N
local processes of M shards each (parallel/multihost.py) and checks their
proofs against each other and the single-process prove; ranks that share a
card must name --backend gloo. contribute applies one phase-2 ceremony
contribution (circom/contribute.py) and verify-chain checks a key's
contribution chain (zkey.verify_mpc_chain). verify-onchain runs the compiled
Solidity verifier (the reference's verifier_artifact.json, --artifact) on the
in-process EVM (evm.py). `--timings` before the command prints the
stage table of utils/trace.py to stderr when the command finishes.
proof.json / public.json / verification_key.json match snarkjs's JSON
schema (decimal strings, G2 as [[c0,c1],...]).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List

from .utils import paths

DEFAULT_SOCKET = os.path.join(tempfile.gettempdir(), "circom_compat_prove.sock")


def _fmt_g1(p) -> List[str]:
    if p is None:
        return ["0", "1", "0"]
    return [str(p[0]), str(p[1]), "1"]


def _fmt_g2(p) -> List[List[str]]:
    if p is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    (x0, x1), (y0, y1) = p
    return [[str(x0), str(x1)], [str(y0), str(y1)], ["1", "0"]]


def _parse_g1(v):
    x, y, z = (int(c) for c in v)
    if z == 0:
        return None
    if z != 1:
        # snarkjs emits affine points (z == 1); any other z would silently
        # alias a different point if read as affine
        raise ValueError(f"G1 point has non-affine z = {z}")
    return (x, y)


def _parse_g2(v):
    (x0, x1), (y0, y1), (z0, z1) = ((int(a), int(b)) for a, b in v)
    if z0 == 0 and z1 == 0:
        return None
    if (z0, z1) != (1, 0):
        raise ValueError(f"G2 point has non-affine z = ({z0}, {z1})")
    return ((x0, x1), (y0, y1))


def _proof_to_json(proof) -> dict:
    return {
        "pi_a": _fmt_g1(proof.a),
        "pi_b": _fmt_g2(proof.b),
        "pi_c": _fmt_g1(proof.c),
        "protocol": "groth16",
        "curve": "bn128",
    }


def _proof_from_json(d):
    from .models.groth16 import Proof

    return Proof(a=_parse_g1(d["pi_a"]), b=_parse_g2(d["pi_b"]), c=_parse_g1(d["pi_c"]))


def _vk_to_json(vk) -> dict:
    return {
        "protocol": "groth16",
        "curve": "bn128",
        "nPublic": len(vk.gamma_abc_g1) - 1,
        "vk_alpha_1": _fmt_g1(vk.alpha_g1),
        "vk_beta_2": _fmt_g2(vk.beta_g2),
        "vk_gamma_2": _fmt_g2(vk.gamma_g2),
        "vk_delta_2": _fmt_g2(vk.delta_g2),
        "IC": [_fmt_g1(p) for p in vk.gamma_abc_g1],
    }


def _vk_from_json(d):
    from .circom.zkey import VerifyingKey

    return VerifyingKey(
        alpha_g1=_parse_g1(d["vk_alpha_1"]),
        beta_g2=_parse_g2(d["vk_beta_2"]),
        gamma_g2=_parse_g2(d["vk_gamma_2"]),
        delta_g2=_parse_g2(d["vk_delta_2"]),
        gamma_abc_g1=[_parse_g1(p) for p in d["IC"]],
    )


def _load_json(path):
    with open(path) as fh:
        return json.load(fh)


def _dump_json(obj, path) -> None:
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)


def _prove_and_write(pk, matrices, assignment, public, args) -> int:
    """Prove with fresh randomizers on args.device, write proof and public."""
    from .models.groth16 import Groth16, random_scalar

    proof = Groth16.create_proof_with_reduction_and_matrices(
        pk, random_scalar(), random_scalar(), matrices, matrices.num_instance_variables,
        matrices.num_constraints, assignment, device=args.device, backend=args.backend)
    _dump_json(_proof_to_json(proof), args.proof)
    _dump_json([str(v) for v in public], args.public)
    print(f"wrote {args.proof}, {args.public}")
    return 0


def cmd_witness(args) -> int:
    from .circom.wtns import write_wtns
    from .witness import WitnessCalculator

    wc = WitnessCalculator.from_file(args.wasm, engine=args.engine)
    witness = wc.calculate_witness(_load_json(args.inputs), sanity_check=args.sanity_check)
    write_wtns(witness, args.out)
    print(f"wrote {len(witness)} witness values to {args.out}")
    return 0


def cmd_prove(args) -> int:
    """zkey + wtns -> proof.json + public.json. The witness goes to the
    prover as the wtns file's (N, 16) limbs, with no Python-int pass."""
    from .circom.wtns import read_wtns_limbs
    from .circom.zkey import read_zkey
    from .ops import limbs as limb_codec

    pk, matrices = read_zkey(args.zkey)
    limbs = read_wtns_limbs(args.witness)
    public = limb_codec.limbs_to_ints(limbs[1 : matrices.num_instance_variables])
    return _prove_and_write(pk, matrices, limbs, public, args)


def cmd_fullprove(args) -> int:
    """snarkjs `groth16 fullprove` analogue: wasm + inputs + zkey ->
    proof.json + public.json in one step."""
    from .circom.zkey import read_zkey
    from .witness import WitnessCalculator

    wc = WitnessCalculator.from_file(args.wasm, engine=args.engine)
    witness = wc.calculate_witness(_load_json(args.inputs), sanity_check=args.sanity_check)
    pk, matrices = read_zkey(args.zkey)
    return _prove_and_write(pk, matrices, witness,
                            witness[1 : matrices.num_instance_variables], args)


def cmd_export_calldata(args) -> int:
    """snarkjs `groth16 exportsoliditycalldata`: the Verifier.verifyProof
    argument list, G2 limbs c1 first (ethereum.py's Solidity convention)."""
    from . import ethereum as eth

    proof = _proof_from_json(_load_json(args.proof))
    public = [int(v) for v in _load_json(args.public)]
    (ax, ay), ((bxc1, bxc0), (byc1, byc0)), (cx, cy) = eth.Proof.from_ark(proof).as_tuple()

    def hx(v):
        return f'"0x{v:064x}"'

    print(",".join([
        f"[{hx(ax)},{hx(ay)}]",
        f"[[{hx(bxc1)},{hx(bxc0)}],[{hx(byc1)},{hx(byc0)}]]",
        f"[{hx(cx)},{hx(cy)}]",
        "[" + ",".join(hx(v % (1 << 256)) for v in public) + "]",
    ]))
    return 0


def cmd_r1cs_info(args) -> int:
    """snarkjs `r1cs info` analogue."""
    from .circom.r1cs import read_r1cs

    r1cs = read_r1cs(args.r1cs)
    print(f"# wires:        {r1cs.num_variables}")
    print(f"# constraints:  {len(r1cs.constraints)}")
    print(f"# public (incl. wire one): {r1cs.num_inputs}")
    print(f"# private (aux): {r1cs.num_aux}")
    return 0


def _load_vk(path):
    """verification_key.json, or the vk of a .zkey (by its magic)."""
    from .circom.zkey import read_zkey

    with open(path, "rb") as fh:
        is_zkey = fh.read(4) == b"zkey"
    return read_zkey(path)[0].vk if is_zkey else _vk_from_json(_load_json(path))


def cmd_verify(args) -> int:
    from .models.groth16 import verify_proof

    vk = _load_vk(args.vkey)
    public = [int(v) for v in _load_json(args.public)]
    proof = _proof_from_json(_load_json(args.proof))
    ok = verify_proof(vk, proof, public)
    print("OK!" if ok else "INVALID proof")
    return 0 if ok else 1


def cmd_export_vkey(args) -> int:
    from .circom.zkey import read_zkey

    pk, _ = read_zkey(args.zkey)
    _dump_json(_vk_to_json(pk.vk), args.out)
    print(f"wrote {args.out}")
    return 0


def cmd_setup(args) -> int:
    from .circom.circuit import CircomCircuit
    from .circom.r1cs import read_r1cs
    from .circom.zkey_writer import write_zkey
    from .models import generate_random_parameters

    circuit = CircomCircuit(r1cs=read_r1cs(args.r1cs))
    pk = generate_random_parameters(circuit, device=args.device)
    ma, mb, _ = circuit.to_matrices()
    write_zkey(args.zkey_out, pk, ma, mb, len(ma))
    if args.vkey_out:
        _dump_json(_vk_to_json(pk.vk), args.vkey_out)
    print(f"dev-mode setup: {pk.n_vars} vars, domain {pk.domain_size}; wrote {args.zkey_out}"
          + (f", {args.vkey_out}" if args.vkey_out else ""))
    return 0


def cmd_contribute(args) -> int:
    """snarkjs `zkey contribute` equivalent (circom/contribute.py)."""
    from .circom.contribute import contribute
    from .circom.zkey import read_zkey
    from .circom.zkey_writer import write_zkey

    pk, matrices = read_zkey(args.zkey_in)
    entropy = args.entropy.encode() if args.entropy else None
    pk2 = contribute(pk, entropy=entropy, name=args.name, device=args.device)
    write_zkey(args.zkey_out, pk2, matrices.a, matrices.b, matrices.num_constraints)
    print(f"contribution #{len(pk2.mpc.contributions)} applied; wrote {args.zkey_out}")
    print("note: contributor keys use the generator-based binding (g2_spx = G2*s); "
          "`verify-chain` fully validates them, but snarkjs' own `zkey verify` binds g2_spx to "
          "a hash-to-G2 of its transcript and will reject this chain (see "
          "circom/contribute.py).")
    return 0


def cmd_verify_chain(args) -> int:
    """Check the ceremony contribution chain in a zkey."""
    from .circom.zkey import read_zkey, verify_mpc_chain

    pk, _ = read_zkey(args.zkey)
    n = len(pk.mpc.contributions) if pk.mpc else 0
    ok = verify_mpc_chain(pk)
    print(f"{n} contribution(s): " + ("chain OK" if ok else "chain INVALID"))
    if ok and n:
        print("note: checked contributor-key consistency + per-link delta pairings from the G1 "
              "generator; ptau/transcript validation (snarkjs `zkey verify` vs the ceremony's "
              "powers-of-tau) is out of scope without the original ptau file.")
    return 0 if ok else 1


def cmd_verify_onchain(args) -> int:
    """Run the compiled Solidity Groth16 verifier on the in-process EVM
    (evm.py) against a proof: the reference's tests/solidity.rs flow
    without an external node. A missing artifact raises
    FileNotFoundError."""
    from . import ethereum as eth
    from .evm import EVMError, check_proof_onchain, load_verifier

    vk = _load_vk(args.vkey)
    public = [int(v) for v in _load_json(args.public)]
    proof = _proof_from_json(_load_json(args.proof))
    vm = load_verifier(args.artifact)
    try:
        ok = check_proof_onchain(vm, eth.Inputs.from_fr(public), eth.Proof.from_ark(proof),
                                 eth.VerifyingKey.from_ark(vk))
    except EVMError as exc:
        print(f"EVM {exc}")
        return 1
    print("OK! (on-chain)" if ok else "INVALID proof (on-chain)")
    return 0 if ok else 1


def cmd_serve(args) -> int:
    """Resident prove server: load and stage the key once, build the
    kernels and warm up, then serve proofs over a unix socket (server.py)."""
    import time

    from .server import ProveServer

    t_all = time.perf_counter()
    print(f"[serve] loading {args.zkey} ...", flush=True)
    server = ProveServer(args.zkey, args.wasm, device=args.device, engine=args.engine)
    print(f"[serve] zkey load {server.load_s:.3f} s, staging {server.stage_s:.3f} s on "
          f"{server.dpk.device} (window_bits={server.window_bits}); warming up ...", flush=True)
    server.warmup()
    print(f"[serve] warm-up {server.compile_s:.3f} s; cold-to-ready "
          f"{time.perf_counter() - t_all:.3f} s", flush=True)

    def ready():
        print(f"[serve] ready on {args.socket}", flush=True)

    server.serve(args.socket, ready_cb=ready)
    print(f"[serve] shut down after {server.n_proofs} proofs", flush=True)
    return 0


def cmd_prove_client(args) -> int:
    """Send one prove request (or a ping) to a running `serve`."""
    from .server import request

    if args.inputs:
        req = {"inputs": _load_json(args.inputs)}
    elif args.witness:
        req = {"witness_file": args.witness}
    else:
        req = {"cmd": "ping"}
    resp = request(args.socket, req, timeout=args.timeout)
    if not resp.get("ok"):
        print(json.dumps(resp), file=sys.stderr)
        return 1
    if "proof" in resp:
        _dump_json(resp["proof"], args.proof)
        _dump_json(resp["public"], args.public)
        print(f"wrote {args.proof}, {args.public} (prove {resp['prove_s']} s)")
    else:
        print(json.dumps(resp))
    return 0


def cmd_dist_dryrun(args) -> int:
    """Multi-process prove on local worker processes over torch.distributed
    (parallel/multihost.dist_dryrun): one JSON line with the layout, the
    devices used and the times."""
    from .parallel.multihost import dist_dryrun

    rec = dist_dryrun(num_processes=args.processes, local_devices=args.local_devices,
                      chain_k=args.chain_k, two_level=args.two_level, timeout=args.timeout,
                      device=args.device, backend=args.backend)
    print(json.dumps({"ok": True, "processes": rec["processes"], "devices": rec["devices"],
                      "mesh": rec["mesh"], "physical_devices": rec["physical_devices"],
                      "backend": rec["backend"], "proof_matches_single_process": True,
                      "wall_s": rec["wall_s"], "worker_prove_s": rec["worker_prove_s"],
                      "launches": rec["launches"]}))
    return 0


def _device_option(p) -> None:
    p.add_argument("--device", default=None,
                   help="torch device to prove on (default: the card; 'cpu' runs the "
                        "kernels' plain versions)")


def _engine_option(p) -> None:
    p.add_argument("--engine", default="aot", choices=("aot", "native", "interp"),
                   help="WASM engine of the witness generator: aot (default; C emitted and "
                        "built by gcc once per module), native (the C++ bytecode VM, built "
                        "by g++), interp (pure Python)")


def _backend_option(p) -> None:
    p.add_argument("--backend", default="device", choices=("device", "streamed"),
                   help="device: the key staged whole; streamed: the query sections sent "
                        "to the device in chunks")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="circom_compat_tpu_torch")
    ap.add_argument("--timings", action="store_true",
                    help="print a per-stage wall-clock table to stderr when the command "
                         "finishes (utils/trace.py)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    w = sub.add_parser("witness", help="run the WASM witness generator")
    w.add_argument("wasm")
    w.add_argument("inputs")
    w.add_argument("out")
    w.add_argument("--sanity-check", action="store_true")
    _engine_option(w)
    w.set_defaults(fn=cmd_witness)

    p = sub.add_parser("prove", help="Groth16 prove from zkey + wtns")
    p.add_argument("zkey")
    p.add_argument("witness")
    p.add_argument("proof")
    p.add_argument("public")
    _device_option(p)
    _backend_option(p)
    p.set_defaults(fn=cmd_prove)

    fp = sub.add_parser("fullprove", help="witness + prove in one step (snarkjs fullprove)")
    fp.add_argument("inputs")
    fp.add_argument("wasm")
    fp.add_argument("zkey")
    fp.add_argument("proof")
    fp.add_argument("public")
    fp.add_argument("--sanity-check", action="store_true")
    _engine_option(fp)
    _device_option(fp)
    _backend_option(fp)
    fp.set_defaults(fn=cmd_fullprove)

    ec = sub.add_parser("export-calldata", help="proof + public -> Solidity verifyProof "
                                                "calldata (snarkjs exportsoliditycalldata)")
    ec.add_argument("public")
    ec.add_argument("proof")
    ec.set_defaults(fn=cmd_export_calldata)

    ri = sub.add_parser("r1cs-info", help="print r1cs header summary")
    ri.add_argument("r1cs")
    ri.set_defaults(fn=cmd_r1cs_info)

    v = sub.add_parser("verify", help="verify a proof")
    v.add_argument("vkey", help="verification_key.json or .zkey")
    v.add_argument("public")
    v.add_argument("proof")
    v.set_defaults(fn=cmd_verify)

    e = sub.add_parser("export-vkey", help="zkey -> verification_key.json")
    e.add_argument("zkey")
    e.add_argument("out")
    e.set_defaults(fn=cmd_export_vkey)

    s = sub.add_parser("setup", help="dev-mode trusted setup from r1cs")
    s.add_argument("r1cs")
    s.add_argument("zkey_out")
    s.add_argument("vkey_out", nargs="?", default=None)
    _device_option(s)
    s.set_defaults(fn=cmd_setup)

    c = sub.add_parser("contribute", help="apply a phase-2 ceremony contribution")
    c.add_argument("zkey_in")
    c.add_argument("zkey_out")
    c.add_argument("--name", default="")
    c.add_argument("--entropy", default=None, help="deterministic entropy (else urandom)")
    _device_option(c)
    c.set_defaults(fn=cmd_contribute)

    vc = sub.add_parser("verify-chain", help="check the zkey contribution chain")
    vc.add_argument("zkey")
    vc.set_defaults(fn=cmd_verify_chain)

    vo = sub.add_parser("verify-onchain",
                        help="verify via the Solidity contract on the built-in EVM")
    vo.add_argument("vkey", help="verification_key.json or .zkey")
    vo.add_argument("public")
    vo.add_argument("proof")
    vo.add_argument("--artifact", default=str(paths.verifier_artifact()),
                    help="solc/hardhat artifact with deployedBytecode")
    vo.set_defaults(fn=cmd_verify_onchain)

    sv = sub.add_parser("serve", help="resident prove server: stage and warm up once, then "
                                      "serve proofs over a unix socket")
    sv.add_argument("zkey")
    sv.add_argument("--wasm", default=None, help="witness wasm so requests can send raw inputs")
    sv.add_argument("--socket", default=DEFAULT_SOCKET)
    _engine_option(sv)
    _device_option(sv)
    sv.set_defaults(fn=cmd_serve)

    pc = sub.add_parser("prove-client", help="send one prove request (or ping) to a running "
                                             "`serve`")
    pc.add_argument("--socket", default=DEFAULT_SOCKET)
    pc.add_argument("--inputs", default=None, help="inputs json (needs a --wasm serve)")
    pc.add_argument("--witness", default=None, help=".wtns file path")
    pc.add_argument("--proof", default="proof.json")
    pc.add_argument("--public", default="public.json")
    pc.add_argument("--timeout", type=float, default=600.0)
    pc.set_defaults(fn=cmd_prove_client)

    dd = sub.add_parser("dist-dryrun", help="multi-process prove on local worker processes, "
                                            "checked against the single-process prove")
    dd.add_argument("--processes", type=int, default=2)
    dd.add_argument("--local-devices", type=int, default=2, help="shards a process")
    dd.add_argument("--chain-k", type=int, default=62,
                    help="squaring-chain constraints (domain = k + 2)")
    dd.add_argument("--two-level", action="store_true",
                    help="use the (dcn, shards) two-level mesh")
    dd.add_argument("--timeout", type=float, default=900.0)
    dd.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="torch.distributed backend (default: nccl on cards, gloo on the CPU)")
    _device_option(dd)
    dd.set_defaults(fn=cmd_dist_dryrun)

    args = ap.parse_args(argv)
    if args.timings:
        from .utils import trace

        with trace.collect() as tr:
            rc = args.fn(args)
        print("--- stage timings ---", file=sys.stderr)
        print(tr.table(), file=sys.stderr)
        return rc
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
