// Native execution engine for Circom witness-generator WASM.
//
// Plays the role Wasmer plays in the reference stack (reference:
// Cargo.toml:16-17, src/witness/witness_calculator.rs:63-89): it executes
// the circuit dataflow triggered by setInputSignal and the getWitness
// readback loop at native speed. The Python layer keeps the WASM *parser*
// and structured-control compiler (witness/wasm/interp.py) and hands this
// VM the flat pre-branched bytecode; only the hot interpreter loop lives
// here. Host imports (runtime.* callbacks) are C function pointers back
// into Python.
//
// Value model: every slot is a uint64_t; i32 ops mask to 32 bits exactly
// like the Python interpreter's unsigned normalization. Float opcodes are
// compiled to a trap (Circom-generated witness code is integer-only; a
// module that needs them runs on engine="interp").
//
// Build: g++ -O3 -shared -fPIC -pthread, at first use, by
// circom_compat_tpu_torch/_host_build.py (engine="native").

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>

namespace {

constexpr uint64_t M32 = 0xFFFFFFFFull;

// Pseudo-opcodes matching witness/wasm/interp.py's flat representation.
enum : uint32_t {
  OP_UNREACHABLE = 0x00,
  OP_NOP = 0x101,
  OP_JUMP = 0x105,
  OP_IF_FALSE_JUMP = 0x104,
  OP_BR = 0x0C,
  OP_BR_IF = 0x0D,
  OP_BR_TABLE = 0x0E,
  OP_RETURN = 0x0F,
  OP_CALL = 0x10,
  OP_CALL_INDIRECT = 0x11,
  OP_DROP = 0x1A,
  OP_SELECT = 0x1B,
  OP_LOCAL_GET = 0x20,
  OP_LOCAL_SET = 0x21,
  OP_LOCAL_TEE = 0x22,
  OP_GLOBAL_GET = 0x23,
  OP_GLOBAL_SET = 0x24,
  OP_MEMSIZE = 0x3F,
  OP_MEMGROW = 0x40,
  OP_CONST = 0x41,
  OP_MEMCOPY = 0x1FC0A,
  OP_MEMFILL = 0x1FC0B,
  OP_TRAP_FLOAT = 0xFFFF1,  // placeholder for unsupported float ops
};

struct Insn {
  uint32_t op;
  int64_t a;
  int64_t b;
};

struct Branch {
  int32_t target;
  int32_t keep;
  int32_t entry;
};

struct Func {
  std::vector<Insn> code;
  std::vector<Branch> branches;           // for BR / BR_IF: a = index
  std::vector<std::vector<Branch>> tables; // for BR_TABLE: a = index (last = default)
  uint32_t n_params = 0;
  uint32_t n_results = 0;
  uint32_t n_locals = 0;  // extra zero-initialized locals
};

// Host import callback: args, n_args, results, n_results; return 0 ok,
// nonzero -> trap (Python side stores the pending exception).
typedef int (*HostFn)(const int64_t*, int32_t, int64_t*, int32_t);

struct Import {
  HostFn fn;
  uint32_t n_params;
  uint32_t n_results;
};

struct VM {
  std::vector<Import> imports;
  std::vector<Func> funcs;   // local functions (index = wasm idx - n_imports)
  std::vector<uint64_t> globals;
  std::vector<int32_t> table;  // -1 = null
  std::vector<uint8_t> memory;
  uint32_t max_pages = 65536;
  std::string error;
  std::vector<uint64_t> stack;  // reused across calls
  int depth = 0;  // vm_call nesting (host callbacks may re-enter)

  bool trap(const char* msg) {
    error = msg;
    return false;
  }

  bool invoke(uint32_t func_index, const uint64_t* args, uint32_t n_args,
              uint64_t* results, uint32_t* n_results_out);
  bool run(const Func& f, std::vector<uint64_t>& locals, size_t base);
};

static inline int64_t s32(uint64_t v) { return (int32_t)(uint32_t)v; }
static inline int64_t s64(uint64_t v) { return (int64_t)v; }

bool VM::invoke(uint32_t func_index, const uint64_t* args, uint32_t n_args,
                uint64_t* results, uint32_t* n_results_out) {
  if (func_index < imports.size()) {
    const Import& im = imports[func_index];
    int64_t res[8] = {0};
    int rc = im.fn(reinterpret_cast<const int64_t*>(args), (int32_t)n_args, res,
                   (int32_t)im.n_results);
    if (rc != 0) return trap("host import raised");
    for (uint32_t i = 0; i < im.n_results; i++) results[i] = (uint64_t)res[i];
    *n_results_out = im.n_results;
    return true;
  }
  uint32_t li = func_index - (uint32_t)imports.size();
  if (li >= funcs.size()) return trap("function index out of range");
  const Func& f = funcs[li];
  std::vector<uint64_t> locals(f.n_params + f.n_locals, 0);
  for (uint32_t i = 0; i < n_args && i < f.n_params; i++) locals[i] = args[i];
  size_t base = stack.size();
  if (!run(f, locals, base)) return false;
  uint32_t nr = f.n_results;
  *n_results_out = nr;
  for (uint32_t i = 0; i < nr; i++)
    results[i] = stack[stack.size() - nr + i];
  stack.resize(base);
  return true;
}

bool VM::run(const Func& f, std::vector<uint64_t>& locals, size_t base) {
  const Insn* code = f.code.data();
  size_t n = f.code.size();
  size_t pc = 0;
  std::vector<uint64_t>& st = stack;

  auto apply_branch = [&](const Branch& br) {
    size_t entry = base + (size_t)br.entry;
    if (br.keep) {
      size_t from = st.size() - (size_t)br.keep;
      for (int32_t i = 0; i < br.keep; i++) st[entry + i] = st[from + i];
      st.resize(entry + br.keep);
    } else {
      st.resize(entry);
    }
    pc = (size_t)br.target;
  };

  while (pc < n) {
    const Insn& in = code[pc];
    switch (in.op) {
      case OP_LOCAL_GET: st.push_back(locals[in.a]); break;
      case OP_CONST: st.push_back((uint64_t)in.a); break;
      case OP_LOCAL_SET: locals[in.a] = st.back(); st.pop_back(); break;
      case OP_LOCAL_TEE: locals[in.a] = st.back(); break;
      case OP_GLOBAL_GET: st.push_back(globals[in.a]); break;
      case OP_GLOBAL_SET: globals[in.a] = st.back(); st.pop_back(); break;
      case OP_DROP: st.pop_back(); break;
      case OP_SELECT: {
        uint64_t c = st.back(); st.pop_back();
        uint64_t v2 = st.back(); st.pop_back();
        if (!c) st.back() = v2;
        break;
      }
      case OP_NOP: break;
      case OP_JUMP: pc = (size_t)in.a; continue;
      case OP_IF_FALSE_JUMP: {
        uint64_t c = st.back(); st.pop_back();
        if (!c) { pc = (size_t)in.a; continue; }
        break;
      }
      case OP_BR: { apply_branch(f.branches[in.a]); continue; }
      case OP_BR_IF: {
        uint64_t c = st.back(); st.pop_back();
        if (c) { apply_branch(f.branches[in.a]); continue; }
        break;
      }
      case OP_BR_TABLE: {
        uint64_t idx = st.back(); st.pop_back();
        const std::vector<Branch>& tbl = f.tables[in.a];
        const Branch& br = idx < tbl.size() - 1 ? tbl[idx] : tbl.back();
        apply_branch(br);
        continue;
      }
      case OP_RETURN: {
        uint32_t nr = (uint32_t)in.a;
        if (nr) {
          size_t from = st.size() - nr;
          for (uint32_t i = 0; i < nr; i++) st[base + i] = st[from + i];
          st.resize(base + nr);
        } else {
          st.resize(base);
        }
        return true;
      }
      case OP_CALL: {
        uint32_t fidx = (uint32_t)in.a;
        uint32_t np = (uint32_t)(in.b & 0xFFFF);
        uint64_t argbuf[16];
        for (uint32_t i = 0; i < np; i++) argbuf[i] = st[st.size() - np + i];
        st.resize(st.size() - np);
        uint64_t res[8];
        uint32_t nr = 0;
        if (!invoke(fidx, argbuf, np, res, &nr)) return false;
        for (uint32_t i = 0; i < nr; i++) st.push_back(res[i]);
        break;
      }
      case OP_CALL_INDIRECT: {
        uint64_t ei = st.back(); st.pop_back();
        if (ei >= table.size() || table[ei] < 0)
          return trap("undefined element in call_indirect");
        uint32_t fidx = (uint32_t)table[ei];
        uint32_t np = (uint32_t)in.a;
        uint64_t argbuf[16];
        for (uint32_t i = 0; i < np; i++) argbuf[i] = st[st.size() - np + i];
        st.resize(st.size() - np);
        uint64_t res[8];
        uint32_t nr = 0;
        if (!invoke(fidx, argbuf, np, res, &nr)) return false;
        for (uint32_t i = 0; i < nr; i++) st.push_back(res[i]);
        break;
      }
      case OP_MEMSIZE: st.push_back(memory.size() >> 16); break;
      case OP_MEMGROW: {
        uint64_t delta = st.back();
        uint64_t old = memory.size() >> 16;
        uint64_t want = old + delta;
        if (want > max_pages) {
          st.back() = M32;  // -1
        } else {
          memory.resize(want << 16, 0);
          st.back() = old;
        }
        break;
      }
      case OP_MEMCOPY: {
        uint64_t ln = st.back(); st.pop_back();
        uint64_t src = st.back(); st.pop_back();
        uint64_t dst = st.back(); st.pop_back();
        if (src + ln > memory.size() || dst + ln > memory.size())
          return trap("out of bounds memory access");
        std::memmove(memory.data() + dst, memory.data() + src, ln);
        break;
      }
      case OP_MEMFILL: {
        uint64_t ln = st.back(); st.pop_back();
        uint64_t val = st.back(); st.pop_back();
        uint64_t dst = st.back(); st.pop_back();
        if (dst + ln > memory.size()) return trap("out of bounds memory access");
        std::memset(memory.data() + dst, (int)(val & 0xFF), ln);
        break;
      }
      case OP_UNREACHABLE: return trap("unreachable executed");
      case OP_TRAP_FLOAT: return trap("float opcode not supported natively");

      // ---- loads (a = static offset) ----
      case 0x28: case 0x29: case 0x2C: case 0x2D: case 0x2E: case 0x2F:
      case 0x30: case 0x31: case 0x32: case 0x33: case 0x34: case 0x35: {
        uint64_t addr = (st.back() & M32) + (uint64_t)in.a;
        uint64_t v = 0;
        switch (in.op) {
          case 0x28: {  // i32.load
            if (addr + 4 > memory.size()) return trap("oob load");
            uint32_t x; std::memcpy(&x, memory.data() + addr, 4); v = x; break;
          }
          case 0x29: {  // i64.load
            if (addr + 8 > memory.size()) return trap("oob load");
            std::memcpy(&v, memory.data() + addr, 8); break;
          }
          case 0x2C: { if (addr + 1 > memory.size()) return trap("oob load");
            int8_t x = (int8_t)memory[addr]; v = (uint32_t)(int32_t)x; break; }
          case 0x2D: { if (addr + 1 > memory.size()) return trap("oob load");
            v = memory[addr]; break; }
          case 0x2E: { if (addr + 2 > memory.size()) return trap("oob load");
            int16_t x; std::memcpy(&x, memory.data() + addr, 2);
            v = (uint32_t)(int32_t)x; break; }
          case 0x2F: { if (addr + 2 > memory.size()) return trap("oob load");
            uint16_t x; std::memcpy(&x, memory.data() + addr, 2); v = x; break; }
          case 0x30: { if (addr + 1 > memory.size()) return trap("oob load");
            int8_t x = (int8_t)memory[addr]; v = (uint64_t)(int64_t)x; break; }
          case 0x31: { if (addr + 1 > memory.size()) return trap("oob load");
            v = memory[addr]; break; }
          case 0x32: { if (addr + 2 > memory.size()) return trap("oob load");
            int16_t x; std::memcpy(&x, memory.data() + addr, 2);
            v = (uint64_t)(int64_t)x; break; }
          case 0x33: { if (addr + 2 > memory.size()) return trap("oob load");
            uint16_t x; std::memcpy(&x, memory.data() + addr, 2); v = x; break; }
          case 0x34: { if (addr + 4 > memory.size()) return trap("oob load");
            int32_t x; std::memcpy(&x, memory.data() + addr, 4);
            v = (uint64_t)(int64_t)x; break; }
          case 0x35: { if (addr + 4 > memory.size()) return trap("oob load");
            uint32_t x; std::memcpy(&x, memory.data() + addr, 4); v = x; break; }
        }
        st.back() = v;
        break;
      }

      // ---- stores (a = static offset) ----
      case 0x36: case 0x37: case 0x3A: case 0x3B: case 0x3C: case 0x3D:
      case 0x3E: {
        uint64_t val = st.back(); st.pop_back();
        uint64_t addr = (st.back() & M32) + (uint64_t)in.a; st.pop_back();
        uint32_t size =
            in.op == 0x36 ? 4 : in.op == 0x37 ? 8 :
            in.op == 0x3A ? 1 : in.op == 0x3B ? 2 :
            in.op == 0x3C ? 1 : in.op == 0x3D ? 2 : 4;
        if (addr + size > memory.size()) return trap("oob store");
        std::memcpy(memory.data() + addr, &val, size);
        break;
      }

      default: {
        // Unary / binary numeric ops.
        uint32_t op = in.op;
        if (op == 0x45) { st.back() = (st.back() & M32) == 0; break; }
        if (op == 0x50) { st.back() = st.back() == 0; break; }
        if (op == 0x67) { uint32_t x = (uint32_t)st.back();
          st.back() = x ? __builtin_clz(x) : 32; break; }
        if (op == 0x68) { uint32_t x = (uint32_t)st.back();
          st.back() = x ? __builtin_ctz(x) : 32; break; }
        if (op == 0x69) { st.back() = __builtin_popcount((uint32_t)st.back()); break; }
        if (op == 0x79) { uint64_t x = st.back();
          st.back() = x ? __builtin_clzll(x) : 64; break; }
        if (op == 0x7A) { uint64_t x = st.back();
          st.back() = x ? __builtin_ctzll(x) : 64; break; }
        if (op == 0x7B) { st.back() = __builtin_popcountll(st.back()); break; }
        if (op == 0xA7) { st.back() &= M32; break; }           // i32.wrap_i64
        if (op == 0xAC) { st.back() = (uint64_t)s32(st.back()); break; }  // extend_s
        if (op == 0xAD) { st.back() &= M32; break; }           // extend_u
        if (op == 0xC0) { st.back() = (uint32_t)(int32_t)(int8_t)st.back(); break; }
        if (op == 0xC1) { st.back() = (uint32_t)(int32_t)(int16_t)st.back(); break; }
        if (op == 0xC2) { st.back() = (uint64_t)(int64_t)(int8_t)st.back(); break; }
        if (op == 0xC3) { st.back() = (uint64_t)(int64_t)(int16_t)st.back(); break; }
        if (op == 0xC4) { st.back() = (uint64_t)(int64_t)(int32_t)st.back(); break; }

        if (op >= 0x46 && op <= 0xA6) {
          uint64_t b = st.back(); st.pop_back();
          uint64_t a = st.back();
          uint64_t r = 0;
          switch (op) {
            case 0x46: r = (a & M32) == (b & M32); break;
            case 0x47: r = (a & M32) != (b & M32); break;
            case 0x48: r = s32(a) < s32(b); break;
            case 0x49: r = (a & M32) < (b & M32); break;
            case 0x4A: r = s32(a) > s32(b); break;
            case 0x4B: r = (a & M32) > (b & M32); break;
            case 0x4C: r = s32(a) <= s32(b); break;
            case 0x4D: r = (a & M32) <= (b & M32); break;
            case 0x4E: r = s32(a) >= s32(b); break;
            case 0x4F: r = (a & M32) >= (b & M32); break;
            case 0x51: r = a == b; break;
            case 0x52: r = a != b; break;
            case 0x53: r = s64(a) < s64(b); break;
            case 0x54: r = a < b; break;
            case 0x55: r = s64(a) > s64(b); break;
            case 0x56: r = a > b; break;
            case 0x57: r = s64(a) <= s64(b); break;
            case 0x58: r = a <= b; break;
            case 0x59: r = s64(a) >= s64(b); break;
            case 0x5A: r = a >= b; break;
            case 0x6A: r = (a + b) & M32; break;
            case 0x6B: r = (a - b) & M32; break;
            case 0x6C: r = (a * b) & M32; break;
            case 0x6D: {  // i32.div_s
              int32_t x = (int32_t)a, y = (int32_t)b;
              if (y == 0) return trap("integer divide by zero");
              if (x == INT32_MIN && y == -1) return trap("integer overflow");
              r = (uint32_t)(x / y); break;
            }
            case 0x6E: { uint32_t y = (uint32_t)b;
              if (!y) return trap("integer divide by zero");
              r = (uint32_t)a / y; break; }
            case 0x6F: { int32_t x = (int32_t)a, y = (int32_t)b;
              if (!y) return trap("integer divide by zero");
              if (x == INT32_MIN && y == -1) { r = 0; break; }
              r = (uint32_t)(x % y); break; }
            case 0x70: { uint32_t y = (uint32_t)b;
              if (!y) return trap("integer divide by zero");
              r = (uint32_t)a % y; break; }
            case 0x71: r = (a & b) & M32; break;
            case 0x72: r = (a | b) & M32; break;
            case 0x73: r = (a ^ b) & M32; break;
            case 0x74: r = ((uint32_t)a << (b & 31)) & M32; break;
            case 0x75: r = (uint32_t)((int32_t)a >> (b & 31)); break;
            case 0x76: r = ((uint32_t)a) >> (b & 31); break;
            case 0x77: { uint32_t x = (uint32_t)a, k = b & 31;
              r = k ? ((x << k) | (x >> (32 - k))) : x; break; }
            case 0x78: { uint32_t x = (uint32_t)a, k = b & 31;
              r = k ? ((x >> k) | (x << (32 - k))) : x; break; }
            case 0x7C: r = a + b; break;
            case 0x7D: r = a - b; break;
            case 0x7E: r = a * b; break;
            case 0x7F: { int64_t x = (int64_t)a, y = (int64_t)b;
              if (!y) return trap("integer divide by zero");
              if (x == INT64_MIN && y == -1) return trap("integer overflow");
              r = (uint64_t)(x / y); break; }
            case 0x80: { if (!b) return trap("integer divide by zero");
              r = a / b; break; }
            case 0x81: { int64_t x = (int64_t)a, y = (int64_t)b;
              if (!y) return trap("integer divide by zero");
              if (x == INT64_MIN && y == -1) { r = 0; break; }
              r = (uint64_t)(x % y); break; }
            case 0x82: { if (!b) return trap("integer divide by zero");
              r = a % b; break; }
            case 0x83: r = a & b; break;
            case 0x84: r = a | b; break;
            case 0x85: r = a ^ b; break;
            case 0x86: r = a << (b & 63); break;
            case 0x87: r = (uint64_t)((int64_t)a >> (b & 63)); break;
            case 0x88: r = a >> (b & 63); break;
            case 0x89: { uint64_t k = b & 63;
              r = k ? ((a << k) | (a >> (64 - k))) : a; break; }
            case 0x8A: { uint64_t k = b & 63;
              r = k ? ((a >> k) | (a << (64 - k))) : a; break; }
            default: return trap("unsupported numeric opcode");
          }
          st.back() = r;
          break;
        }
        char buf[64];
        std::snprintf(buf, sizeof buf, "unhandled opcode %#x", op);
        return trap(buf);
      }
    }
    pc++;
  }
  // fell off the end: results are on top of stack (func-level end)
  uint32_t nr = f.n_results;
  if (nr) {
    size_t from = st.size() - nr;
    for (uint32_t i = 0; i < nr; i++) st[base + i] = st[from + i];
    st.resize(base + nr);
  } else {
    st.resize(base);
  }
  return true;
}

}  // namespace

extern "C" {

VM* vm_create() { return new VM(); }
void vm_destroy(VM* vm) { delete vm; }

void vm_set_memory(VM* vm, uint32_t pages, uint32_t max_pages) {
  vm->memory.assign((size_t)pages << 16, 0);
  vm->max_pages = max_pages;
}

void vm_write_memory(VM* vm, uint64_t off, const uint8_t* data, uint64_t n) {
  if (off + n > vm->memory.size()) vm->memory.resize(off + n, 0);
  std::memcpy(vm->memory.data() + off, data, n);
}

void vm_read_memory(VM* vm, uint64_t off, uint8_t* out, uint64_t n) {
  std::memcpy(out, vm->memory.data() + off, n);
}

uint64_t vm_memory_size(VM* vm) { return vm->memory.size(); }

void vm_set_globals(VM* vm, const uint64_t* vals, uint32_t n) {
  vm->globals.assign(vals, vals + n);
}

uint64_t vm_get_global(VM* vm, uint32_t i) { return vm->globals[i]; }

void vm_set_table(VM* vm, const int32_t* entries, uint32_t n) {
  vm->table.assign(entries, entries + n);
}

void vm_add_import(VM* vm, HostFn fn, uint32_t n_params, uint32_t n_results) {
  vm->imports.push_back({fn, n_params, n_results});
}

// ops/a/b: parallel arrays; branches: flat triples (target, keep, entry);
// table_data: flat [count, t,k,e, t,k,e, ...] groups per br_table (a = group
// index), with the LAST triple of each group the default.
int vm_add_func(VM* vm, uint32_t n_params, uint32_t n_results,
                uint32_t n_locals, uint32_t n_insns, const uint32_t* ops,
                const int64_t* a, const int64_t* b, const int32_t* branches,
                uint32_t n_branches, const int32_t* table_data,
                uint32_t table_words) {
  Func f;
  f.n_params = n_params;
  f.n_results = n_results;
  f.n_locals = n_locals;
  f.code.resize(n_insns);
  for (uint32_t i = 0; i < n_insns; i++) f.code[i] = {ops[i], a[i], b[i]};
  f.branches.resize(n_branches);
  for (uint32_t i = 0; i < n_branches; i++)
    f.branches[i] = {branches[i * 3], branches[i * 3 + 1], branches[i * 3 + 2]};
  uint32_t pos = 0;
  while (pos < table_words) {
    uint32_t count = (uint32_t)table_data[pos++];
    std::vector<Branch> tbl(count);
    for (uint32_t i = 0; i < count; i++) {
      tbl[i] = {table_data[pos], table_data[pos + 1], table_data[pos + 2]};
      pos += 3;
    }
    f.tables.push_back(std::move(tbl));
  }
  vm->funcs.push_back(std::move(f));
  return (int)vm->funcs.size() - 1;
}

// Returns 0 on success, 1 on trap (message via vm_last_error).
int vm_call(VM* vm, uint32_t func_index, const uint64_t* args, uint32_t n_args,
            uint64_t* results, uint32_t* n_results) {
  // Reentrant: host callbacks (e.g. printErrorMessage reading the message
  // via getMessageChar) call back in while an outer vm_call is live.
  if (vm->depth == 0) {
    vm->error.clear();
    vm->stack.clear();
  }
  vm->depth++;
  bool ok = vm->invoke(func_index, args, n_args, results, n_results);
  vm->depth--;
  if (vm->depth == 0 && !ok) vm->stack.clear();
  return ok ? 0 : 1;
}

const char* vm_last_error(VM* vm) { return vm->error.c_str(); }

}  // extern "C"
