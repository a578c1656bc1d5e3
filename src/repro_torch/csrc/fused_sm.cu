// fused_sm_run: whole blocks of the soft-GPGPU SM as one CUDA kernel for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/core/pipeline/fused.py::fused_sm_step
// (body _fused_step_kernel) together with the loop around it
// (repro/core/pipeline/__init__.py::run_block_body) and the vmap over
// schedule positions (repro/runtime/executor.py::_run_positions).  The TPU
// kernel runs one lockstep step per launch inside a lax.while_loop; here
// one launch runs a whole dispatch group to completion:
//
//   * one CTA per schedule position; simulated warp w is CUDA warp w, lane
//     for lane, so a lane mask is __ballot_sync and a lane count __popc;
//     threads at or beyond the block's size start EXITed, and a warp
//     without threads starts FINISHED;
//   * registers ([W][R][32], so the lanes of a warp hit distinct banks),
//     predicates, warp stacks, the program, the condition LUT, the SM's
//     shared memory and the block counters live in shared memory; the
//     warp-uniform control state (pc, wstate, sp, alive/active masks)
//     lives in registers, identical in every lane of a warp;
//   * each position's private gmem snapshot and written mask live in
//     global memory, (P, G) int32; the executor merges them afterwards;
//   * every step is a read phase (barrier release, fetch, .S pop, operand
//     and memory reads, ALU), a __syncthreads, and a write phase (register,
//     predicate, smem and gmem stores, warp stack, PC, counters): one
//     step's stores stay invisible to other warps until the next step, as
//     in the reference's scatters;
//   * the loop runs until no warp is left or cycles >= max_cycles, with
//     __syncthreads_or deciding it; there is no host sync per step.
//
// Index semantics follow the JAX package exactly: indices wrap once like
// Python; the code fetch, the stack reads and the LUT clamp; register and
// predicate gathers fill INT_MIN out of range; scatters out of range drop.
// Same-step stores to one address from different lanes have no defined
// winner, as in the reference; parity holds on race-free programs.
//
// What bounds it: each simulated step is a few hundred dependent
// instructions and three block-wide barriers per CTA, and a dispatch
// group fills only P of the card's 132 SMs, so the kernel is bound by
// per-step latency, far above its memory or operation bound.
#include <climits>
#include <cuda_runtime.h>

#include "alu_datapath.cuh"

namespace {

constexpr int READY = 0, WAIT = 1, FINISHED = 2;
constexpr unsigned FULL = 0xffffffffu;
// per-position counter row: op_issues[28], op_lanes[28], then these
constexpr int C_CYCLES = 2 * isa::NUM_OPCODES, C_STACK_OPS = C_CYCLES + 1,
              C_MAX_SP = C_CYCLES + 2, C_OVERFLOW = C_CYCLES + 3,
              C_STEPS = C_CYCLES + 4, N_CTR = C_CYCLES + 5;
// geometry row per position
constexpr int G_LAUNCH = 0, G_BDIM = 1, G_BDX = 2, G_BDY = 3, G_BX = 4,
              G_BY = 5, G_GX = 6, G_GY = 7, N_GEOM = 8;

__device__ __forceinline__ int wrap_index(int i, int n) {
  return i < 0 ? i + n : i;
}
// x[i] on a length-n axis: wrap, then clamp
__device__ __forceinline__ int clamp_index(int i, int n) {
  i = wrap_index(i, n);
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}
__device__ __forceinline__ bool in_mask(int mask, int op) {
  return op >= 0 && op < 32 && ((mask >> op) & 1);
}

struct Smem {
  int* code;   // C * NUM_FIELDS
  int* lut;    // 16 * 16
  int* regs;   // W * R * 32
  int* pred;   // W * 4 * 32
  int* saddr;  // W * D
  int* stype;  // W * D
  int* smask;  // W * D (uint32 lane masks)
  int* smem;   // S
  int* ctr;    // N_CTR
};

__host__ __device__ inline long smem_words(int W, int C, int R, int D, int S) {
  return static_cast<long>(C) * isa::NUM_FIELDS + 256 + W * R * 32 +
         W * 4 * 32 + 3L * W * D + S + N_CTR;
}

__device__ inline Smem carve(int* base, int W, int C, int R, int D, int S) {
  Smem s;
  s.code = base;
  s.lut = s.code + C * isa::NUM_FIELDS;
  s.regs = s.lut + 256;
  s.pred = s.regs + W * R * 32;
  s.saddr = s.pred + W * 4 * 32;
  s.stype = s.saddr + W * D;
  s.smask = s.stype + W * D;
  s.smem = s.smask + W * D;
  s.ctr = s.smem + S;
  return s;
}

template <bool ENABLE_MUL, int NUM_READ_OPERANDS>
__global__ void __launch_bounds__(1024)
    fused_sm_run_kernel(const int* __restrict__ codes,
                        const int* __restrict__ lut,
                        const int* __restrict__ geom,
                        int* __restrict__ gmem_all, int* __restrict__ gw_all,
                        int* __restrict__ ctr_all, int C, int G, int R, int D,
                        int S, int rows, int lat_g, int lat_s,
                        int max_cycles) {
  extern __shared__ int shm[];
  const int W = blockDim.x >> 5;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int* g = geom + blockIdx.x * N_GEOM;
  const int bdim = g[G_BDIM], bdx = g[G_BDX], bdy = g[G_BDY];
  const int bx = g[G_BX], by = g[G_BY], gx = g[G_GX], gy = g[G_GY];
  int* gmem = gmem_all + static_cast<long>(blockIdx.x) * G;
  int* gw = gw_all + static_cast<long>(blockIdx.x) * G;
  Smem s = carve(shm, W, C, R, D, S);

  // ---- init_state ------------------------------------------------------
  const int* code = codes + static_cast<long>(g[G_LAUNCH]) * C *
                                isa::NUM_FIELDS;
  for (int i = tid; i < C * isa::NUM_FIELDS; i += blockDim.x)
    s.code[i] = code[i];
  for (int i = tid; i < 256; i += blockDim.x) s.lut[i] = lut[i];
  const long zero_words = smem_words(W, C, R, D, S) - C * isa::NUM_FIELDS -
                          256;
  for (long i = tid; i < zero_words; i += blockDim.x) s.regs[i] = 0;
  const unsigned exists = __ballot_sync(FULL, tid < bdim);
  unsigned alive = exists, active = exists;
  int wstate = exists ? READY : FINISHED;
  int pc = 0, sp = 0;
  int* my_regs = s.regs + w * R * 32 + lane;   // register r at [r * 32]
  int* my_pred = s.pred + w * 4 * 32 + lane;   // predicate p at [p * 32]
  int* w_saddr = s.saddr + w * D;
  int* w_stype = s.stype + w * D;
  int* w_smask = s.smask + w * D;
  int steps = 0;
  __syncthreads();

  while (true) {
    // loop condition of run_block_body: some warp left, under max_cycles
    if (!__syncthreads_or(wstate != FINISHED) ||
        s.ctr[C_CYCLES] >= max_cycles)
      break;
    // ---- read phase: barrier release (fetch_decode) ---------------------
    const bool any_ready = __syncthreads_or(wstate == READY);
    if (!any_ready && wstate == WAIT) wstate = READY;
    const bool issued = wstate == READY;

    // ---- fetch / decode ---------------------------------------------------
    const int* ins = s.code + clamp_index(pc, C) * isa::NUM_FIELDS;
    const int op = ins[isa::F_OP], dst = ins[isa::F_DST];
    const int src1 = ins[isa::F_SRC1], src2 = ins[isa::F_SRC2];
    const int src3 = ins[isa::F_SRC3], imm = ins[isa::F_IMM];
    const int flags = ins[isa::F_FLAGS], gpred = ins[isa::F_GPRED];
    const int gcond = ins[isa::F_GCOND], pdst = ins[isa::F_PDST];
    const bool guarded = flags & isa::FLAG_GUARD;

    // .S reconvergence pop
    const int top = min(max(sp - 1, 0), D - 1);
    const int top_addr = w_saddr[top], top_type = w_stype[top];
    const unsigned top_mask = static_cast<unsigned>(w_smask[top]);
    const bool do_pop = issued && (flags & isa::FLAG_SYNC) && sp > 0;
    const bool pop_taken = do_pop && top_type == isa::STACK_TAKEN;
    const unsigned act = do_pop ? top_mask : active;
    const int dsp = sp - (do_pop ? 1 : 0);
    const bool exec_this = issued && !pop_taken;

    // ---- read operands ------------------------------------------------------
    const int gp = wrap_index(gpred, 4);
    const int nib = (gp >= 0 && gp < 4) ? my_pred[gp * 32] : INT_MIN;
    const bool cond =
        s.lut[clamp_index(gcond, 16) * 16 + clamp_index(nib, 16)] != 0;
    const bool part = ((act & alive) >> lane) & 1u && exec_this;
    const bool ex = part && (!guarded || cond);
    auto gather = [&](int r) {
      r = wrap_index(r, R);
      return (r >= 0 && r < R) ? my_regs[r * 32] : INT_MIN;
    };
    const int s1 = (flags & isa::FLAG_SRC1_IMM) ? imm : gather(src1);
    const int s2 = (flags & isa::FLAG_SRC2_IMM) ? imm : gather(src2);
    const int s3 = NUM_READ_OPERANDS >= 3 ? gather(src3) : 0;
    int s2r = 0;
    if (op == isa::S2R) {
      switch (min(max(imm, 0), isa::NUM_SPECIAL_REGS - 1)) {
        case 0: s2r = tid % bdx; break;
        case 1: s2r = tid / bdx; break;
        case 2: s2r = bx; break;
        case 3: s2r = by; break;
        case 4: s2r = bdx; break;
        case 5: s2r = bdy; break;
        case 6: s2r = gx; break;
        case 7: s2r = gy; break;
        case 8: s2r = tid; break;
        case 9: s2r = static_cast<int>(static_cast<unsigned>(by) * gx + bx);
          break;
        default: s2r = static_cast<int>(static_cast<unsigned>(bdx) * bdy);
      }
    }
    const int addr = static_cast<int>(static_cast<unsigned>(s1) +
                                      static_cast<unsigned>(imm));
    const int gaddr = min(max(addr, 0), G - 1);
    const int saddr = min(max(addr, 0), S - 1);

    // ---- execute (the memory read ports merge by opcode) ------------------
    int res, nib_new;
    alu_datapath<ENABLE_MUL, NUM_READ_OPERANDS>(op, s1, s2, s3, cond, s2r, ex,
                                                res, nib_new);
    if (op == isa::LDG)
      res = gmem[gaddr];
    else if (op == isa::LDS)
      res = s.smem[saddr];

    const bool taken = guarded ? (part && cond) : part;
    const unsigned taken_m = __ballot_sync(FULL, taken);
    const unsigned ntk_m = __ballot_sync(FULL, part && !taken);
    const unsigned part_m = __ballot_sync(FULL, part);
    const unsigned exec_m = __ballot_sync(FULL, ex);
    __syncthreads();

    // ---- write phase: register / predicate writeback, stores ------------
    if (ex && in_mask(isa::WRITES_REG_MASK, op)) {
      const int d = wrap_index(dst, R);
      if (d >= 0 && d < R) my_regs[d * 32] = res;
    }
    if (ex && op == isa::ISETP) {
      const int d = wrap_index(pdst, 4);
      if (d >= 0 && d < 4) my_pred[d * 32] = nib_new;
    }
    if (ex && op == isa::STG) {
      gmem[gaddr] = s2;
      gw[gaddr] = 1;
    }
    if (ex && op == isa::STS) s.smem[saddr] = s2;

    // ---- control: warp stack, EXIT, BAR, next PC ---------------------------
    const bool is_bra = op == isa::BRA && exec_this;
    const bool is_ssy = op == isa::SSY && exec_this;
    const bool diverge = is_bra && taken_m && ntk_m;
    const bool uni_taken = is_bra && taken_m && !ntk_m;
    const bool do_push = diverge || is_ssy;
    const int slot = min(max(dsp, 0), D - 1);
    if (do_push && lane == 0) {
      w_saddr[slot] = imm;
      w_stype[slot] = is_ssy ? isa::STACK_RECONV : isa::STACK_TAKEN;
      w_smask[slot] = static_cast<int>(is_ssy ? part_m : taken_m);
    }
    const bool overflow_now = do_push && dsp >= D;
    int sp_new = dsp + (do_push ? 1 : 0);
    const bool is_exit = op == isa::EXIT && exec_this;
    const unsigned alive_new = is_exit ? (alive & ~exec_m) : alive;
    const bool warp_done = is_exit && alive_new == 0;
    const bool exit_resume = is_exit && !warp_done && sp_new > 0;
    const int etop = min(max(sp_new - 1, 0), D - 1);
    __syncwarp();
    const int e_addr = w_saddr[etop], e_type = w_stype[etop];
    const unsigned e_mask = static_cast<unsigned>(w_smask[etop]);
    sp_new -= exit_resume ? 1 : 0;
    const unsigned active_new = exit_resume ? (e_mask & alive_new)
                                : diverge   ? ntk_m
                                : is_exit   ? alive_new
                                            : act;
    const bool resume_jump = exit_resume && e_type == isa::STACK_TAKEN;
    const int pc_next =
        pop_taken ? top_addr
        : uni_taken ? imm
        : resume_jump ? e_addr
                      : static_cast<int>(static_cast<unsigned>(pc) + 1u);
    const bool is_bar = op == isa::BAR && exec_this;

    // ---- counters --------------------------------------------------------------
    if (lane == 0) {
      int cost = 0;
      if (issued)
        cost = exec_this ? rows + (in_mask(isa::IS_GMEM_MASK, op) ? lat_g : 0) +
                               (in_mask(isa::IS_SMEM_MASK, op) ? lat_s : 0)
                         : 1;  // a TAKEN pop costs one cycle
      const int op_c = wrap_index(exec_this ? op : isa::NOP, isa::NUM_OPCODES);
      if (op_c >= 0 && op_c < isa::NUM_OPCODES) {
        if (exec_this) atomicAdd(&s.ctr[op_c], 1);
        if (exec_m) atomicAdd(&s.ctr[isa::NUM_OPCODES + op_c], __popc(exec_m));
      }
      if (cost) atomicAdd(&s.ctr[C_CYCLES], cost);
      const int sops = int(do_push) + int(do_pop) + int(exit_resume);
      if (sops) atomicAdd(&s.ctr[C_STACK_OPS], sops);
      atomicMax(&s.ctr[C_MAX_SP], sp_new);
      if (overflow_now) atomicOr(&s.ctr[C_OVERFLOW], 1);
    }
    if (issued) pc = pc_next;
    wstate = warp_done ? FINISHED : (is_bar ? WAIT : wstate);
    alive = alive_new;
    active = active_new;
    sp = sp_new;
    ++steps;
  }

  // the loop left through a __syncthreads_or: every counter update is in
  if (tid == 0) s.ctr[C_STEPS] = steps;
  __syncthreads();
  int* ctr = ctr_all + static_cast<long>(blockIdx.x) * N_CTR;
  for (int i = tid; i < N_CTR; i += blockDim.x) ctr[i] = s.ctr[i];
}

template <bool ENABLE_MUL, int NUM_READ_OPERANDS>
int launch(const int* codes, const int* lut, const int* geom, int* gmem,
           int* gw, int* ctr, int P, int W, int C, int G, int R, int D, int S,
           int rows, int lat_g, int lat_s, int max_cycles,
           cudaStream_t stream) {
  auto kernel = fused_sm_run_kernel<ENABLE_MUL, NUM_READ_OPERANDS>;
  const size_t bytes = smem_words(W, C, R, D, S) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<P, W * 32, bytes, stream>>>(codes, lut, geom, gmem, gw, ctr, C, G,
                                       R, D, S, rows, lat_g, lat_s,
                                       max_cycles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory one CTA needs, in bytes (the wrapper raises above
// the card's 227 KB per block).
extern "C" long fused_sm_smem_bytes(int W, int C, int R, int D, int S) {
  return smem_words(W, C, R, D, S) * static_cast<long>(sizeof(int));
}

// codes (L, C, 10); lut (256,) 0/1; geom (P, 8); gmem and gw (P, G), run
// in place; ctr (P, N_CTR) out.  Returns cudaGetLastError() after launch.
extern "C" int fused_sm_run_launch(const int* codes, const int* lut,
                                   const int* geom, int* gmem, int* gw,
                                   int* ctr, int P, int W, int C, int G,
                                   int R, int D, int S, int rows, int lat_g,
                                   int lat_s, int max_cycles, int enable_mul,
                                   int num_read_operands, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (enable_mul && num_read_operands >= 3)
    return launch<true, 3>(codes, lut, geom, gmem, gw, ctr, P, W, C, G, R, D,
                           S, rows, lat_g, lat_s, max_cycles, s);
  if (enable_mul)
    return launch<true, 2>(codes, lut, geom, gmem, gw, ctr, P, W, C, G, R, D,
                           S, rows, lat_g, lat_s, max_cycles, s);
  if (num_read_operands >= 3)
    return launch<false, 3>(codes, lut, geom, gmem, gw, ctr, P, W, C, G, R, D,
                            S, rows, lat_g, lat_s, max_cycles, s);
  return launch<false, 2>(codes, lut, geom, gmem, gw, ctr, P, W, C, G, R, D,
                          S, rows, lat_g, lat_s, max_cycles, s);
}
