// Batched merge-tree apply on Hopper (sm_90a), by hand in CUDA C++.
//
// Replaces the TPU kernel fluidframework_tpu/ops/pallas_apply.py::
// pallas_apply_ops_batch (and computes exactly what its XLA twin
// ops/apply.py::apply_ops_batch computes): K sequenced merge-tree ops
// (insert / remove / annotate), applied in order to each of D docs, with
// each doc's state held on chip across the K loop and written back once.
// The plain PyTorch version is ops/apply.py::apply_ops_batch_ref in the
// port; ops/cuda_apply.py is the wrapper that builds and launches this.
//
// What bounds it on this card. Per wave the kernel must move the state in
// and out once (10 int32 [D, S] planes counting the two [D, S, P] prop
// tables as 2P planes) plus the [D, K, 12] op rows: at D=8192, S=256, P=8,
// K=64 that is about 0.45 GB, ~0.13 ms at 3.35 TB/s. The work is K
// dependent steps per doc, each a block-wide prefix scan and reductions
// over S slots, tens of int32 operations per slot per op: ~0.1-0.2 T int32
// operations, some ms at the card's int32 rate. So it is bound by
// operations, and by the latency of the barriers that chain them.
//
// What the design does about it. One CTA per doc, one thread per slot
// (blockDim = S rounded up to a warp; threads past S are inert slots that
// take part in every shuffle and barrier). The slot's 8 fields and its P
// prop entries live in registers for the whole K loop, so device memory
// is touched once per wave, not once per op. Per op: a warp-shuffle
// inclusive scan plus one cross-warp pass through shared memory (barrier
// A); one combined pass of warp reductions for the first-True indices and
// the split extracts (barrier B); and, only when the op adds slots, one
// staging of every field through shared memory to shift by 1 or 2
// (barrier C). NOOP padding and refused ops skip the rest uniformly.
// Making it fast (several docs per CTA, K-pipelining, fusing the wave
// unpack and zamboni) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int F_TYPE = 0, F_POS = 1, F_END = 2, F_SEQ = 3, F_REFSEQ = 4,
              F_CLIENT = 5, F_TLEN = 6, F_TSTART = 7, F_FLAGS = 9,
              F_KEY = 10, F_VAL = 11, OP_FIELDS = 12;
constexpr int OP_INSERT = 1, OP_REMOVE = 2, OP_ANNOTATE = 3;
constexpr int32_t NO_SEQ = -1, NO_CLIENT = -1, NO_KEY = -1, NO_VAL = -1;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 32;
constexpr int N_RED = 9;     // j1, j2, idx0, c1, l1, ts1, c2, l2, ts2
constexpr int N_SLOT = 8;    // slot fields held per thread

struct Args {
  const int32_t* ops;         // [D, K, 12]
  const int32_t* in[N_SLOT];  // [D, S] each
  const int32_t* in_pk;       // [D, S, P]
  const int32_t* in_pv;       // [D, S, P]
  const int32_t* in_count;    // [D]
  const uint8_t* in_ovf;      // [D] (bool)
  int32_t* out[N_SLOT];
  int32_t* out_pk;
  int32_t* out_pv;
  int32_t* out_count;
  uint8_t* out_ovf;
  int S;
  int K;
};

// field order in registers and in the shift staging rows
enum { LEN, TS, FL, ISEQ, ICL, RSEQ, RCA, RCB };

template <int P>
__global__ void __launch_bounds__(1024) apply_kernel(Args a) {
  extern __shared__ int32_t stage[];  // [(N_SLOT + 2 + 2P)][S]
  __shared__ int32_t warp_sum[MAX_WARPS];
  __shared__ int32_t red[N_RED][MAX_WARPS];

  const int d = blockIdx.x;
  const int i = threadIdx.x;
  const int S = a.S;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool slot = i < S;
  const size_t row = (size_t)d * S + i;

  int32_t f[N_SLOT];
  int32_t pk[P], pv[P];
  if (slot) {
#pragma unroll
    for (int q = 0; q < N_SLOT; ++q) f[q] = a.in[q][row];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      pk[p] = a.in_pk[row * P + p];
      pv[p] = a.in_pv[row * P + p];
    }
  } else {  // inert slot: never visible, never written
    f[LEN] = 0; f[TS] = 0; f[FL] = 0; f[ISEQ] = 0; f[ICL] = NO_CLIENT;
    f[RSEQ] = NO_SEQ; f[RCA] = NO_CLIENT; f[RCB] = NO_CLIENT;
#pragma unroll
    for (int p = 0; p < P; ++p) { pk[p] = NO_KEY; pv[p] = 0; }
  }
  int32_t count = a.in_count[d];
  bool bad_any = false;    // uniform across the block
  bool ovf_local = false;  // third remover / full prop table at this slot

  const int32_t* ops = a.ops + (size_t)d * a.K * OP_FIELDS;
  for (int k = 0; k < a.K; ++k) {
    const int32_t* op = ops + (size_t)k * OP_FIELDS;
    const int32_t typ = __ldg(op + F_TYPE);
    const bool is_ins = typ == OP_INSERT;
    const bool is_rem = typ == OP_REMOVE;
    const bool is_ann = typ == OP_ANNOTATE;
    if (!(is_ins || is_rem || is_ann)) continue;  // NOOP: state unchanged
    const int32_t pos = __ldg(op + F_POS), end = __ldg(op + F_END);
    const int32_t seq = __ldg(op + F_SEQ), ref = __ldg(op + F_REFSEQ);
    const int32_t client = __ldg(op + F_CLIENT);
    const int32_t p2 = is_ins ? pos : end;

    // ---- visibility at (ref, client) and the exclusive prefix sum
    const bool in_use = slot && i < count;
    const bool ins_seen = (f[ICL] == client) || (f[ISEQ] <= ref);
    const bool removed = (f[RSEQ] != NO_SEQ) &&
        (f[RCA] == client || f[RCB] == client || f[RSEQ] <= ref);
    const bool vis = in_use && ins_seen && !removed;
    const int32_t vlen = vis ? f[LEN] : 0;
    int32_t x = vlen;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();  // A
    int32_t prefix = 0, total = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int32_t s = warp_sum[w];
      if (w < warp) prefix += s;
      total += s;
    }
    const int32_t inc = prefix + x;
    const int32_t cum = inc - vlen;

    // ---- split detection, first-True indices and split extracts
    const bool inside1 = vis && cum < pos && pos < inc;
    const bool inside2 = vis && cum < p2 && p2 < inc;
    const bool at0 = slot && cum >= pos;
    int32_t r[N_RED] = {
        inside1 ? i : S, inside2 ? i : S, at0 ? i : S,
        inside1 ? cum : 0, inside1 ? f[LEN] : 0, inside1 ? f[TS] : 0,
        inside2 ? cum : 0, inside2 ? f[LEN] : 0, inside2 ? f[TS] : 0};
#pragma unroll
    for (int q = 0; q < 3; ++q) r[q] = __reduce_min_sync(FULL, r[q]);
#pragma unroll
    for (int q = 3; q < N_RED; ++q) r[q] = __reduce_add_sync(FULL, r[q]);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < N_RED; ++q) red[q][warp] = r[q];
    }
    __syncthreads();  // B
#pragma unroll
    for (int q = 0; q < N_RED; ++q) {
      int32_t v = red[q][0];
      for (int w = 1; w < nwarps; ++w)
        v = q < 3 ? min(v, red[q][w]) : v + red[q][w];
      r[q] = v;
    }
    const int32_t j1 = r[0], j2 = r[1], idx0 = r[2];
    const int32_t c1 = r[3], l1 = r[4], ts1 = r[5];
    const int32_t c2 = r[6], l2 = r[7], ts2 = r[8];

    const bool bad_shape = is_ins ? (pos > total) : (end > total || end <= pos);
    const bool s1_raw = j1 < S;
    const bool s2_raw = !is_ins && j2 < S;
    const int needed = (int)s1_raw + (int)s2_raw + (int)is_ins;
    const bool bad = bad_shape || count + needed > S;
    if (bad) {  // refused op: only the sticky overflow flag changes
      bad_any = true;
      continue;
    }
    const bool s1 = s1_raw, s2 = s2_raw, do_ins = is_ins;
    const int32_t o1 = pos - c1, o2 = p2 - c2;
    const bool same = s1 && s2 && j1 == j2;
    const int32_t s1i = s1 ? 1 : 0;
    const int32_t p_ins = s1 ? j1 + 1 : idx0;
    const int32_t p_n1 = do_ins ? p_ins + 1 : j1 + 1;
    const int32_t p_h2 = j2 + s1i;
    const int32_t p_n2 = j2 + 1 + s1i;

    // ---- shift by 0/1/2 through shared memory, only when slots are added
    bool vis_o = vis;
    int32_t cum_o = cum;
    if (s1 || s2 || do_ins) {
      const int delta = (s1 && i >= p_n1) + (s2 && i >= p_n2) +
                        (do_ins && i >= p_ins);
      if (slot) {
#pragma unroll
        for (int q = 0; q < N_SLOT; ++q) stage[q * S + i] = f[q];
        stage[N_SLOT * S + i] = vis ? 1 : 0;
        stage[(N_SLOT + 1) * S + i] = cum;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          stage[(N_SLOT + 2 + p) * S + i] = pk[p];
          stage[(N_SLOT + 2 + P + p) * S + i] = pv[p];
        }
      }
      __syncthreads();  // C
      if (slot && delta > 0) {
        int src = i - delta;
        if (src < 0) src += S;  // wraps like jnp.roll; never selected
#pragma unroll
        for (int q = 0; q < N_SLOT; ++q) f[q] = stage[q * S + src];
        vis_o = stage[N_SLOT * S + src] != 0;
        cum_o = stage[(N_SLOT + 1) * S + src];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          pk[p] = stage[(N_SLOT + 2 + p) * S + src];
          pv[p] = stage[(N_SLOT + 2 + P + p) * S + src];
        }
      }
      // no trailing barrier: the next write to `stage` follows barriers A
      // and B of a later op, which every thread reaches only after its
      // reads here

      // point patches, in the JAX rebuild's order (later ones win)
      const bool head1_at = s1 && i == j1;
      const bool n1_at = s1 && i == p_n1;
      const bool h2_at = s2 && !same && i == p_h2;
      const bool n2_at = s2 && i == p_n2;
      const bool new_at = do_ins && i == p_ins;
      if (head1_at) f[LEN] = o1;
      if (n1_at) f[LEN] = same ? o2 - o1 : l1 - o1;
      if (h2_at) f[LEN] = o2;
      if (n2_at) f[LEN] = l2 - o2;
      if (n1_at) f[TS] = ts1 + o1;
      if (n2_at) f[TS] = ts2 + o2;
      if (n1_at) cum_o = c1 + o1;
      if (n2_at) cum_o = c2 + o2;
      if (new_at) {
        const int32_t tlen = __ldg(op + F_TLEN);
        f[LEN] = tlen > 0 ? tlen : 1;
        f[TS] = __ldg(op + F_TSTART);
        f[FL] = __ldg(op + F_FLAGS);
        f[ISEQ] = seq;
        f[ICL] = client;
        f[RSEQ] = NO_SEQ;
        f[RCA] = NO_CLIENT;
        f[RCB] = NO_CLIENT;
#pragma unroll
        for (int p = 0; p < P; ++p) { pk[p] = NO_KEY; pv[p] = 0; }
      }
      count += s1i + (s2 ? 1 : 0) + (do_ins ? 1 : 0);
    }

    // ---- remove stamps / annotate writes on the covered slots
    if (slot && !is_ins) {
      const int32_t vlen_o = vis_o ? f[LEN] : 0;
      const bool covered = vis_o && cum_o >= pos && cum_o + vlen_o <= end;
      if (covered && is_rem) {
        if (f[RSEQ] == NO_SEQ) {  // fresh remove
          f[RSEQ] = seq;
          f[RCA] = client;
        } else if (f[RCA] != client) {  // overlap: extra remover
          if (f[RCB] == NO_CLIENT) f[RCB] = client;
          else if (f[RCB] != client) ovf_local = true;  // a third one
        }
      } else if (covered) {  // annotate: per-key last writer wins
        const int32_t key = __ldg(op + F_KEY), val = __ldg(op + F_VAL);
        int tm = P, te = P;
#pragma unroll
        for (int p = P - 1; p >= 0; --p) {
          if (pk[p] == key) tm = p;
          if (pk[p] == NO_KEY) te = p;
        }
        const bool has_key = tm < P, has_empty = te < P;
        const bool is_delete = val == NO_VAL;
        const int tgt = has_key ? tm : te;
        if (has_key || (!is_delete && has_empty)) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            if (p == tgt) {
              pk[p] = is_delete ? NO_KEY : key;
              pv[p] = is_delete ? 0 : val;
            }
          }
        } else if (!is_delete) {
          ovf_local = true;  // a (P+1)th distinct key: escalate
        }
      }
    }
  }

  const bool ovf_any = __syncthreads_or(ovf_local) != 0;
  if (slot) {
#pragma unroll
    for (int q = 0; q < N_SLOT; ++q) a.out[q][row] = f[q];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      a.out_pk[row * P + p] = pk[p];
      a.out_pv[row * P + p] = pv[p];
    }
  }
  if (i == 0) {
    a.out_count[d] = count;
    a.out_ovf[d] = (a.in_ovf[d] != 0 || bad_any || ovf_any) ? 1 : 0;
  }
}

template <int P>
cudaError_t launch(const Args& a, int D, cudaStream_t stream) {
  const int threads = ((a.S + 31) / 32) * 32;
  const size_t smem = (size_t)(N_SLOT + 2 + 2 * P) * a.S * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        apply_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  apply_kernel<P><<<D, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Applies a [D, K, 12] int32 wave to D docs: reads the 12 input state
// planes, writes the 12 output planes (distinct buffers). Launches on
// `stream`, allocates nothing, returns cudaGetLastError() (0 = launched).
int ff_apply_ops_batch(
    const void* ops,
    const void* length, const void* text_start, const void* flags,
    const void* ins_seq, const void* ins_client, const void* rem_seq,
    const void* rem_client_a, const void* rem_client_b,
    const void* prop_key, const void* prop_val,
    const void* count, const void* overflow,
    void* o_length, void* o_text_start, void* o_flags,
    void* o_ins_seq, void* o_ins_client, void* o_rem_seq,
    void* o_rem_client_a, void* o_rem_client_b,
    void* o_prop_key, void* o_prop_val,
    void* o_count, void* o_overflow,
    int D, int S, int P, int K, void* stream) {
  if (D <= 0 || K < 0 || S <= 0 || S > 1024) return (int)cudaErrorInvalidValue;
  Args a;
  a.ops = static_cast<const int32_t*>(ops);
  const void* in[N_SLOT] = {length, text_start, flags, ins_seq, ins_client,
                            rem_seq, rem_client_a, rem_client_b};
  void* out[N_SLOT] = {o_length, o_text_start, o_flags, o_ins_seq,
                       o_ins_client, o_rem_seq, o_rem_client_a,
                       o_rem_client_b};
  for (int q = 0; q < N_SLOT; ++q) {
    a.in[q] = static_cast<const int32_t*>(in[q]);
    a.out[q] = static_cast<int32_t*>(out[q]);
  }
  a.in_pk = static_cast<const int32_t*>(prop_key);
  a.in_pv = static_cast<const int32_t*>(prop_val);
  a.in_count = static_cast<const int32_t*>(count);
  a.in_ovf = static_cast<const uint8_t*>(overflow);
  a.out_pk = static_cast<int32_t*>(o_prop_key);
  a.out_pv = static_cast<int32_t*>(o_prop_val);
  a.out_count = static_cast<int32_t*>(o_count);
  a.out_ovf = static_cast<uint8_t*>(o_overflow);
  a.S = S;
  a.K = K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // P is a compile-time constant so that each thread's prop entries stay
  // in registers; the port's doc state uses P = 8
  if (P != 8) return (int)cudaErrorInvalidValue;
  return (int)launch<8>(a, D, s);
}

const char* ff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
