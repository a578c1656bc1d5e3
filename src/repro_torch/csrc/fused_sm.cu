// fused_sm_run: whole blocks of the soft-GPGPU SM as one CUDA kernel for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/core/pipeline/fused.py::fused_sm_step
// (body _fused_step_kernel) together with the loop around it
// (repro/core/pipeline/__init__.py::run_block_body) and the vmap over
// schedule positions (repro/runtime/executor.py::_run_positions).  The TPU
// kernel runs one lockstep step per launch inside a lax.while_loop; here
// one launch runs a whole dispatch group to completion: one CTA per
// schedule position, simulated warp w is CUDA warp w, lane for lane, so a
// lane mask is a ballot and a lane count __popc.  Threads at or beyond the
// block's size start EXITed; a warp without threads starts FINISHED.
//
// What bounds it: latency, not bytes or operations.  A dispatch group
// fills P of the card's 132 SMs with one CTA each, and every simulated
// step is one dependent chain per warp ended by a block-wide barrier, with
// one or two warps on each of the SM's schedulers to hide it, so the time
// is (steps) x (one step's chain + barrier), far above the bytes bound.
// On the executor's default path P is the whole batch, so the blocks'
// chains run side by side in one launch.
// The design shortens that chain:
//
//   * one __syncthreads per step.  At the end of its step each warp
//     publishes one slot {flags, cycles so far}: still live, READY, and
//     whether the instruction at its next pc is STS or STG.  Slots are
//     double-buffered by step parity, so the one barrier at the step
//     boundary orders both their writes and their reads.  After it every
//     warp reduces the W slots with __reduce_or_sync/__reduce_add_sync:
//     loop exit, barrier release and the cycle total against max_cycles.
//     Only a step in which some slot says "store" takes a second barrier
//     between its loads and its stores, so no load of step t sees a store
//     of step t (stores of step t land before the next step's boundary);
//   * no shared atomics in the step: op_issues and op_lanes are counted in
//     registers, lane k of a warp holding opcode k's two counts; cycles,
//     stack ops, max_sp and overflow are per-warp registers.  All of them
//     are reduced into the position's counter row once, after the loop;
//   * predecoded instructions: core/pipeline/fused.py::predecode turns
//     each (10,) instruction into one 16-byte record (REC_* below) with
//     the register and predicate indices already wrapped, "out of range"
//     explicit, the LUT row, the cycle cost and the write/load/store/
//     control tests resolved; a fetch is one vector shared load;
//   * warp-private work before the barrier: at the end of step t a warp
//     fetches step t+1's record and does all that depends on its own state
//     only (operand gathers, guard LUT and its ballot, stack top, ALU
//     result, memory address).  After the barrier remain the vote, the
//     LDS/LDG, and the masks that depend on whether the warp issues;
//   * few branches on the chain: the ALU selects its result by the
//     opcode's bits (alu_datapath.cuh), S2R reads a table, the writes are
//     predicated, and the control stage (warp stack, EXIT, BAR, branch
//     targets) runs only for the instructions the record marks as control
//     or .S; every other instruction just moves to pc + 1.
//
// Registers ([W][R][32], lanes on distinct banks), predicates, warp
// stacks, the program's records and the SM's shared memory live in shared
// memory; each position's private gmem snapshot and written mask in
// global memory, (P, G) int32, merged by the executor afterwards.
//
// Index semantics follow the JAX package exactly: indices wrap once like
// Python; the code fetch, the stack reads and the LUT clamp; register and
// predicate gathers fill INT_MIN out of range; scatters out of range drop.
// Same-step stores to one address from different lanes have no defined
// winner, as in the reference; parity holds on race-free programs.
#include <climits>
#include <cuda_runtime.h>

#include "alu_datapath.cuh"

namespace {

constexpr int READY = 0, WAIT = 1, FINISHED = 2;
constexpr unsigned FULL = 0xffffffffu;
// per-position counter row: op_issues[28], op_lanes[28], then these
constexpr int C_CYCLES = 2 * isa::NUM_OPCODES, C_STACK_OPS = C_CYCLES + 1,
              C_MAX_SP = C_CYCLES + 2, C_OVERFLOW = C_CYCLES + 3,
              C_STEPS = C_CYCLES + 4, C_STORE_STEPS = C_CYCLES + 5,
              N_CTR = C_CYCLES + 6;
// geometry row per position
constexpr int G_LAUNCH = 0, G_BDIM = 1, G_BDX = 2, G_BDY = 3, G_BX = 4,
              G_BY = 5, G_GX = 6, G_GY = 7, N_GEOM = 8;
// predecoded record, int4 {imm, regs, ctl, lut_cost}:
//   .y  dst | src1 << 8 | src2 << 16 | src3 << 24, REG_NONE out of range
//   .z  op | ctr << REC_CTR | pdst << REC_PDST | gpred << REC_GPRED |
//       sel << REC_SEL | flags << REC_FLAGS and one bit each:
//       REC_WREG (writes a register in range), REC_WPRED (ISETP to a
//       predicate in range), REC_LOAD, REC_STORE, REC_CONTROL (BRA, SSY,
//       EXIT, BAR or .S: the control stage runs)
//   .w  LUT row (bit n: the guard holds on nibble n) | cost << REC_COST
// op is OP_NONE outside the ISA, ctr CTR_NONE when the opcode wraps out
// of the counter row.
constexpr int REG_NONE = 255, PRED_NONE = 7, OP_NONE = 31, CTR_NONE = 31;
constexpr int REC_CTR = 5, REC_PDST = 10, REC_GPRED = 13, REC_SEL = 16,
              REC_FLAGS = 20, REC_WREG = 24, REC_WPRED = 25, REC_LOAD = 26,
              REC_STORE = 27, REC_CONTROL = 28, REC_COST = 16;
// slot flags a warp publishes for the next step
constexpr int V_LIVE = 1, V_READY = 2, V_STORE = 4;
static_assert(OP_NONE >= isa::NUM_OPCODES && CTR_NONE >= isa::NUM_OPCODES,
              "the sentinels lie outside the opcodes");

__device__ __forceinline__ int clamp_index(int i, int n) {
  i = i < 0 ? i + n : i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

struct Smem {
  int4* rec;   // C records
  int2* slot;  // 2 x W slots {flags, cycles}, by step parity
  int* sreg;   // 16: the block's special registers, by S2R selector
  int* regs;   // W * R * 32
  int* pred;   // W * 4 * 32
  int* saddr;  // W * D
  int* stype;  // W * D
  int* smask;  // W * D (uint32 lane masks)
  int* smem;   // S
  int* ctr;    // N_CTR
};

constexpr int HEAD_WORDS = 16;  // sreg

__host__ __device__ inline long smem_words(int W, int C, int R, int D,
                                           int S) {
  return 4L * C + 4L * W + HEAD_WORDS + W * R * 32L + W * 4 * 32L +
         3L * W * D + S + N_CTR;
}

__device__ inline Smem carve(int4* base, int W, int C, int R, int D, int S) {
  Smem s;
  s.rec = base;
  s.slot = reinterpret_cast<int2*>(base + C);
  s.sreg = reinterpret_cast<int*>(s.slot + 2 * W);
  s.regs = s.sreg + HEAD_WORDS;
  s.pred = s.regs + W * R * 32;
  s.saddr = s.pred + W * 4 * 32;
  s.stype = s.saddr + W * D;
  s.smask = s.stype + W * D;
  s.smem = s.smask + W * D;
  s.ctr = s.smem + S;
  return s;
}

// One warp's instruction for the coming step, and everything of it that
// depends on the warp's own state alone.
struct Fetched {
  int imm, z, dst, cost, res, nib, s2, gaddr, saddr, top_addr, top_type;
  unsigned guard_m, top_mask;
  __device__ int op() const { return z & 31; }
  __device__ int bit(int b) const { return (z >> b) & 1; }
  __device__ int field(int b, int width) const {
    return (z >> b) & ((1 << width) - 1);
  }
};

// MAX_THREADS: the block size the kernel is built for (256 or 1024); the
// smaller bound lets ptxas schedule the common 8-warp block more freely.
template <bool ENABLE_MUL, int NUM_READ_OPERANDS, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
    fused_sm_run_kernel(const int4* __restrict__ records,
                        const int* __restrict__ geom,
                        int* __restrict__ gmem_all, int* __restrict__ gw_all,
                        int* __restrict__ ctr_all, int C, int G, int R, int D,
                        int S, int max_cycles) {
  extern __shared__ int4 shm[];
  const int W = blockDim.x >> 5;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int* g = geom + blockIdx.x * N_GEOM;
  const int bdim = g[G_BDIM], bdx = g[G_BDX];
  const int tidx = tid % bdx, tidy = tid / bdx;
  int* gmem = gmem_all + static_cast<long>(blockIdx.x) * G;
  int* gw = gw_all + static_cast<long>(blockIdx.x) * G;
  Smem s = carve(shm, W, C, R, D, S);

  // ---- init_state ------------------------------------------------------
  const int4* rec = records + static_cast<long>(g[G_LAUNCH]) * C;
  for (int i = tid; i < C; i += blockDim.x) s.rec[i] = rec[i];
  if (tid == 0) {  // S2R selectors 2-7, 9 and 10; 0, 1 and 8 per thread
    const int bdy = g[G_BDY], bx = g[G_BX], by = g[G_BY], gx = g[G_GX];
    s.sreg[2] = bx;
    s.sreg[3] = by;
    s.sreg[4] = bdx;
    s.sreg[5] = bdy;
    s.sreg[6] = gx;
    s.sreg[7] = g[G_GY];
    s.sreg[9] = static_cast<int>(static_cast<unsigned>(by) * gx + bx);
    s.sreg[10] = static_cast<int>(static_cast<unsigned>(bdx) * bdy);
  }
  const long zero_words =
      smem_words(W, C, R, D, S) - 4L * C - 4L * W - HEAD_WORDS;
  for (long i = tid; i < zero_words; i += blockDim.x) s.regs[i] = 0;
  const unsigned exists = __ballot_sync(FULL, tid < bdim);
  unsigned alive = exists, active = exists;
  unsigned part0 = exists;                     // active & alive
  int wstate = exists ? READY : FINISHED;
  int pc = 0, sp = 0;
  int* my_regs = s.regs + w * R * 32 + lane;   // register r at [r * 32]
  int* my_pred = s.pred + w * 4 * 32 + lane;   // predicate p at [p * 32]
  int* w_saddr = s.saddr + w * D;
  int* w_stype = s.stype + w * D;
  int* w_smask = s.smask + w * D;
  // per-warp counters; lane k counts opcode k
  unsigned cycles = 0;
  int issues = 0, lanes = 0, stack_ops = 0, max_sp = 0, overflow = 0;
  int steps = 0, store_steps = 0, total = 0;
  const unsigned r_last = R - 1;
  __syncthreads();

  // step t+1's warp-private work, done at the end of step t
  Fetched f = {};
  auto fetch = [&]() {
    const int4 r = s.rec[clamp_index(pc, C)];
    const unsigned y = static_cast<unsigned>(r.y);
    f.imm = r.x;
    f.z = r.z;
    f.dst = (y & 255u) * 32;  // register dst of this lane, if REC_WREG
    f.cost = static_cast<unsigned>(r.w) >> REC_COST;
    // every operand read at once, with no branch: an index out of range
    // (REG_NONE, PRED_NONE) reads a word in range whose value is replaced
    const unsigned i1 = (y >> 8) & 255u, i2 = (y >> 16) & 255u, i3 = y >> 24;
    const int gpred = f.field(REC_GPRED, 3), sel = f.field(REC_SEL, 4);
    const int top = min(max(sp - 1, 0), D - 1);
    const int v1 = my_regs[min(i1, r_last) * 32];
    const int v2 = my_regs[min(i2, r_last) * 32];
    const int v3 = my_regs[min(i3, r_last) * 32];
    const int vp = my_pred[(gpred & 3) * 32];
    const int vs = s.sreg[sel];
    f.top_addr = w_saddr[top];  // the .S pop's entry
    f.top_type = w_stype[top];
    f.top_mask = static_cast<unsigned>(w_smask[top]);
    const int flags = f.field(REC_FLAGS, 4);
    const int s1 = (flags & isa::FLAG_SRC1_IMM) ? f.imm
                   : i1 == REG_NONE             ? INT_MIN
                                                : v1;
    f.s2 = (flags & isa::FLAG_SRC2_IMM) ? f.imm
           : i2 == REG_NONE             ? INT_MIN
                                        : v2;
    const int s3 = NUM_READ_OPERANDS < 3 ? 0 : i3 == REG_NONE ? INT_MIN : v3;
    const int nib = gpred == PRED_NONE ? 0 : vp;
    const bool cond = (r.w >> clamp_index(nib, 16)) & 1;
    const unsigned cond_m = __ballot_sync(FULL, cond);
    f.guard_m = (flags & isa::FLAG_GUARD) ? cond_m : FULL;
    const int s2r = sel == 0 ? tidx : sel == 1 ? tidy : sel == 8 ? tid : vs;
    alu_datapath<ENABLE_MUL, NUM_READ_OPERANDS>(f.op(), s1, f.s2, s3, cond,
                                                s2r, true, f.res, f.nib);
    const int addr = static_cast<int>(static_cast<unsigned>(s1) +
                                      static_cast<unsigned>(f.imm));
    f.gaddr = min(max(addr, 0), G - 1);
    f.saddr = min(max(addr, 0), S - 1);
  };
  auto publish = [&](int parity) {  // every lane stores the same slot
    const int live = wstate != FINISHED;
    s.slot[parity * W + w] = make_int2(
        (live ? V_LIVE : 0) | (wstate == READY ? V_READY : 0) |
            (live && f.bit(REC_STORE) ? V_STORE : 0),
        static_cast<int>(cycles));
  };
  fetch();
  publish(0);
  __syncthreads();

  for (int parity = 0;; parity ^= 1) {
    // ---- after the step boundary: the memory read ports and the vote ----
    const int lds = s.smem[f.saddr];  // in range: read on every step
    int ld = 0;
    if (f.op() == isa::LDG && wstate != FINISHED) ld = gmem[f.gaddr];
    const int2 sl = lane < W ? s.slot[parity * W + lane] : make_int2(0, 0);
    const unsigned votes = __reduce_or_sync(FULL, sl.x);
    total = static_cast<int>(
        __reduce_add_sync(FULL, static_cast<unsigned>(sl.y)));
    // loop condition of run_block_body: some warp left, under max_cycles
    if (!(votes & V_LIVE) || total >= max_cycles) break;
    // barrier release (fetch_decode): no warp READY wakes every waiter
    if (!(votes & V_READY) && wstate == WAIT) wstate = READY;
    const bool issued = wstate == READY;

    // the .S reconvergence pop, and the lane masks
    const bool control = f.bit(REC_CONTROL);
    const bool do_pop = control && issued &&
                        (f.field(REC_FLAGS, 4) & isa::FLAG_SYNC) && sp > 0;
    const bool pop_taken = do_pop && f.top_type == isa::STACK_TAKEN;
    const bool exec_this = issued && !pop_taken;
    const unsigned part_m =
        exec_this ? (do_pop ? f.top_mask & alive : part0) : 0u;
    const unsigned exec_m = part_m & f.guard_m;  // BRA: the taken lanes
    const bool ex = (exec_m >> lane) & 1u;

    // loads of this step before any store of it
    if (votes & V_STORE) {
      __syncthreads();
      ++store_steps;
    }

    // ---- write phase: register / predicate writeback, stores ------------
    const int op = f.op();
    if (ex && f.bit(REC_WREG))
      my_regs[f.dst] = !f.bit(REC_LOAD) ? f.res : op == isa::LDS ? lds : ld;
    if (ex && f.bit(REC_WPRED)) my_pred[f.field(REC_PDST, 3) * 32] = f.nib;
    if (ex && f.bit(REC_STORE)) {
      if (op == isa::STG) {
        gmem[f.gaddr] = f.s2;
        gw[f.gaddr] = 1;
      } else {
        s.smem[f.saddr] = f.s2;
      }
    }

    // ---- counters, per warp --------------------------------------------
    if (issued) cycles += exec_this ? f.cost : 1;  // a TAKEN pop: 1 cycle
    if (exec_this && lane == f.field(REC_CTR, 5)) {
      ++issues;
      lanes += __popc(exec_m);
    }

    // ---- control: warp stack, EXIT, BAR, next PC ---------------------------
    if (!control) {
      if (issued) pc = static_cast<int>(static_cast<unsigned>(pc) + 1u);
    } else {
      const unsigned act = do_pop ? f.top_mask : active;
      const int dsp = sp - (do_pop ? 1 : 0);
      const unsigned ntk_m = part_m & ~exec_m;
      const bool is_bra = op == isa::BRA && exec_this;
      const bool is_ssy = op == isa::SSY && exec_this;
      const bool diverge = is_bra && exec_m && ntk_m;
      const bool uni_taken = is_bra && exec_m && !ntk_m;
      const bool do_push = diverge || is_ssy;
      if (do_push) {
        const int slot = min(max(dsp, 0), D - 1);
        if (lane == 0) {
          w_saddr[slot] = f.imm;
          w_stype[slot] = is_ssy ? isa::STACK_RECONV : isa::STACK_TAKEN;
          w_smask[slot] = static_cast<int>(is_ssy ? part_m : exec_m);
        }
        __syncwarp();
      }
      int sp_new = dsp + (do_push ? 1 : 0);
      const bool is_exit = op == isa::EXIT && exec_this;
      const unsigned alive_new = is_exit ? (alive & ~exec_m) : alive;
      const bool warp_done = is_exit && alive_new == 0;
      const bool exit_resume = is_exit && !warp_done && sp_new > 0;
      int pc_next = static_cast<int>(static_cast<unsigned>(pc) + 1u);
      unsigned active_new = diverge ? ntk_m : (is_exit ? alive_new : act);
      if (exit_resume) {
        const int etop = min(max(sp_new - 1, 0), D - 1);
        active_new = static_cast<unsigned>(w_smask[etop]) & alive_new;
        if (w_stype[etop] == isa::STACK_TAKEN) pc_next = w_saddr[etop];
        --sp_new;
      }
      if (pop_taken)
        pc_next = f.top_addr;
      else if (uni_taken)
        pc_next = f.imm;
      stack_ops += int(do_push) + int(do_pop) + int(exit_resume);
      max_sp = max(max_sp, sp_new);
      overflow |= do_push && dsp >= D;
      if (issued) pc = pc_next;
      wstate = warp_done ? FINISHED
                         : (op == isa::BAR && exec_this ? WAIT : wstate);
      alive = alive_new;
      active = active_new;
      part0 = active & alive;
      sp = sp_new;
    }
    ++steps;

    fetch();
    publish(parity ^ 1);
    __syncthreads();
  }

  // ---- the counters, reduced once into the position's row ---------------
  if (lane < isa::NUM_OPCODES) {
    if (issues) atomicAdd(&s.ctr[lane], issues);
    if (lanes) atomicAdd(&s.ctr[isa::NUM_OPCODES + lane], lanes);
  }
  if (lane == 0) {
    atomicAdd(&s.ctr[C_STACK_OPS], stack_ops);
    atomicMax(&s.ctr[C_MAX_SP], max_sp);
    if (overflow) atomicOr(&s.ctr[C_OVERFLOW], 1);
  }
  if (tid == 0) {
    s.ctr[C_CYCLES] = total;
    s.ctr[C_STEPS] = steps;
    s.ctr[C_STORE_STEPS] = store_steps;
  }
  __syncthreads();
  int* ctr = ctr_all + static_cast<long>(blockIdx.x) * N_CTR;
  for (int i = tid; i < N_CTR; i += blockDim.x) ctr[i] = s.ctr[i];
}

template <bool ENABLE_MUL, int NUM_READ_OPERANDS, int MAX_THREADS>
int launch_sized(const int4* records, const int* geom, int* gmem, int* gw,
                 int* ctr, int P, int W, int C, int G, int R, int D, int S,
                 int max_cycles, cudaStream_t stream) {
  auto kernel =
      fused_sm_run_kernel<ENABLE_MUL, NUM_READ_OPERANDS, MAX_THREADS>;
  const size_t bytes = smem_words(W, C, R, D, S) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<P, W * 32, bytes, stream>>>(records, geom, gmem, gw, ctr, C, G, R,
                                       D, S, max_cycles);
  return static_cast<int>(cudaGetLastError());
}

template <bool ENABLE_MUL, int NUM_READ_OPERANDS>
int launch(const int4* records, const int* geom, int* gmem, int* gw,
           int* ctr, int P, int W, int C, int G, int R, int D, int S,
           int max_cycles, cudaStream_t stream) {
  if (W <= 8)
    return launch_sized<ENABLE_MUL, NUM_READ_OPERANDS, 256>(
        records, geom, gmem, gw, ctr, P, W, C, G, R, D, S, max_cycles,
        stream);
  return launch_sized<ENABLE_MUL, NUM_READ_OPERANDS, 1024>(
      records, geom, gmem, gw, ctr, P, W, C, G, R, D, S, max_cycles, stream);
}

}  // namespace

// Dynamic shared memory one CTA needs, in bytes (the wrapper raises above
// the card's 227 KB per block).
extern "C" long fused_sm_smem_bytes(int W, int C, int R, int D, int S) {
  return smem_words(W, C, R, D, S) * static_cast<long>(sizeof(int));
}

// records (L, C, 4) from predecode; geom (P, 8); gmem and gw (P, G), run
// in place; ctr (P, N_CTR) out.  Returns cudaGetLastError() after launch.
extern "C" int fused_sm_run_launch(const void* records, const int* geom,
                                   int* gmem, int* gw, int* ctr, int P, int W,
                                   int C, int G, int R, int D, int S,
                                   int max_cycles, int enable_mul,
                                   int num_read_operands, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* rec = static_cast<const int4*>(records);
  if (enable_mul && num_read_operands >= 3)
    return launch<true, 3>(rec, geom, gmem, gw, ctr, P, W, C, G, R, D, S,
                           max_cycles, st);
  if (enable_mul)
    return launch<true, 2>(rec, geom, gmem, gw, ctr, P, W, C, G, R, D, S,
                           max_cycles, st);
  if (num_read_operands >= 3)
    return launch<false, 3>(rec, geom, gmem, gw, ctr, P, W, C, G, R, D, S,
                            max_cycles, st);
  return launch<false, 2>(rec, geom, gmem, gw, ctr, P, W, C, G, R, D, S,
                          max_cycles, st);
}
