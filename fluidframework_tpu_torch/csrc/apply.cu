// Batched merge-tree apply on Hopper (sm_90a), by hand in CUDA C++.
//
// Replaces the TPU kernel fluidframework_tpu/ops/pallas_apply.py:355
// (pallas_apply_ops_batch) and computes exactly what its XLA twin
// ops/apply.py::apply_ops_batch computes: K sequenced merge-tree ops
// (insert / remove / annotate), applied in order to each of D docs, with
// each doc's state held on chip across the K loop and written back once.
// The plain PyTorch version is ops/apply.py::apply_ops_batch_ref in the
// port; ops/cuda_apply.py is the wrapper that builds and launches this,
// and its launch_geometry() chooses the layout passed in below.
//
// What bounds it on this card. Per wave the kernel moves the state in and
// out once (96 B a slot at P=8) plus the [D, K, 12] op rows: ~0.13 ms at
// D=8192, S=256, K=64. The work is K dependent steps per doc, each a
// prefix scan and a few reductions over S slots plus a shift of every
// slot by 0, 1 or 2: tens of int32 operations per slot per op, which puts
// the bound on operations (~0.37 ms at that shape). The card's int32
// lanes (16 of each SM's 4 schedulers) are the pipe that fills. The
// earlier design (one CTA per doc, one thread per slot) lost ~11x to that
// bound on shared-memory traffic and 2-3 block barriers per op: every
// thread re-read the cross-warp scan and reduction tables and staged all
// 26 fields of its slot through shared memory on every shift.
//
// What the design does about it.
// - S <= 256: one warp per doc, several docs per CTA, and no block-wide
//   barrier at all. Lane t holds SPT consecutive slots (t*SPT ...
//   t*SPT+SPT-1; SPT = 1, 2, 4 or 8, a template parameter) in registers
//   for the whole K loop. The exclusive prefix sum is a serial in-lane
//   scan then one shuffle scan; the first-True indices and split extracts
//   are an in-lane pass then redux instructions.
// - Inserts and removes / annotates take separate compiled paths, so each
//   does only its own reductions, shift and patches.
// - The shift is done in registers: new slot s takes old slot s - delta(s)
//   with delta non-decreasing, so each value is one or two selects among
//   in-lane neighbours and shuffles from the previous lane.
// - Only what every op reads stays in registers (length, insert and
//   remove stamps, the prop row). Prop tables, text_start and flags sit in
//   shared memory behind a per-slot row index (below), so a shift moves
//   one register per slot for them; a new slot's row is written by a few
//   lanes at once.
// - Op rows are staged into shared memory 16 at a time, per warp.
// - 256 < S <= 1024: one CTA per doc of W = ceil(S/256) warps, each warp
//   as above with SPT = 8; the scan offset, the reductions and the shift's
//   boundary values and rows cross warps through a small shared table,
//   one barrier per combine. Exact, not tuned.
//
// Row invariant. Each slot s carries `row`, an index into its doc's shared
// rows (2P prop entries, text_start, flags), and slot s's values there are
// at row[s]. Over all NS = 32*SPT*W slots, inert ones past S included,
// the rows are a permutation of 0..NS-1. A shift drops exactly as many
// slots off the end (slots NS-1 and NS-2) as it adds, and each new slot
// takes one of the dropped rows: a split tail copies its source's row
// (text_start plus the split offset), a new insert clears it. Inert slots
// are never visible and never a source of a slot below S, and the slots
// from count to S-1 keep the values the plain version gives them: every
// field of every slot, unused ones included, must match it. (So row
// `count` is never handed out: it may still belong to an unused slot.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int F_TYPE = 0, F_POS = 1, F_END = 2, F_SEQ = 3, F_REFSEQ = 4,
              F_CLIENT = 5, F_TLEN = 6, F_TSTART = 7, F_FLAGS = 9,
              F_KEY = 10, F_VAL = 11, OP_FIELDS = 12;
constexpr int OP_INSERT = 1, OP_REMOVE = 2, OP_ANNOTATE = 3;
constexpr int32_t NO_SEQ = -1, NO_CLIENT = -1, NO_KEY = -1, NO_VAL = -1;
constexpr unsigned FULL = 0xffffffffu;
constexpr int P = 8;                     // prop-table capacity
constexpr int ROW = 2 * P;               // keys then values, per table row
constexpr int OP_CHUNK = 16;             // op rows staged per warp at once
constexpr int OPBUF = OP_CHUNK * OP_FIELDS;
constexpr int N_SLOT = 8;                // slot fields written back
constexpr int COMB = 32;                 // per-warp combine row (multi-warp)
constexpr int MAX_THREADS = 128;

// values held in registers per slot: the 6 slot fields that every op's
// visibility reads, then the prop row, then this op's visibility and
// exclusive prefix sum (all shifted together). text_start and flags are
// read only where a slot is made, so they sit in shared memory beside
// the prop rows, indexed by the row.
enum { LEN, ISEQ, ICL, RSEQ, RCA, RCB, PROW, VIS, CUM, N_VAL };
constexpr int N_REG = PROW;  // slot fields held in registers
constexpr int F_TS = 1, F_FL = 2;  // in kernel argument order
// kernel argument order (length, text_start, flags, ins_seq, ...) of the
// register-held field q
__host__ __device__ constexpr int field_of(int q) { return q == LEN ? 0 : q + 2; }
// combine row layout: [0] warp total, [1..6] reductions, [10..27] the
// warp's last two slots' N_VAL values (boundary of the shift)
constexpr int C_TOT = 0, C_RED = 1, C_BND = 10;
static_assert(C_BND + 2 * N_VAL <= COMB, "combine row layout");

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
  int D;
  int S;
  int K;
};

// Shift the first NQ values right by the ops' new slots: with one new
// slot at ja, slot s takes old slot s-1 from ja on; with two (TWO, at
// ja < jb), old s-1 from ja and old s-2 from jb. p1/p2 are the values of
// slots base-1 and base-2 (from the previous lane or warp). The wrap at
// slot 0 (jnp.roll's in the plain version) is never selected: only a new
// insert at slot 0 shifts slot 0, and it overwrites every value there.
template <int SPT, int NQ, bool TWO>
__device__ __forceinline__ void shift_values(int32_t (&v)[N_VAL][SPT],
                                             int base, int ja, int jb,
                                             const int32_t (&p1)[N_VAL],
                                             const int32_t (&p2)[N_VAL]) {
#pragma unroll
  for (int i = SPT - 1; i >= 0; --i) {
    const bool d1 = base + i >= ja;
    const bool d2 = TWO && base + i >= jb;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int32_t m1 = i >= 1 ? v[q][i >= 1 ? i - 1 : 0] : p1[q];
      const int32_t m2 = i >= 2 ? v[q][i >= 2 ? i - 2 : 0]
                                : (i == 1 ? p1[q] : p2[q]);
      v[q][i] = d2 ? m2 : (d1 ? m1 : v[q][i]);
    }
  }
}

// Shared ints of one doc of NS slots (inert ones included): NS prop rows,
// then NS text_starts and NS flags, padded to 16 bytes so that the next
// doc's rows stay aligned for int4.
__host__ __device__ constexpr size_t doc_shared_ints(int NS) {
  return (size_t)NS * ROW + ((2 * (size_t)NS + 3) & ~(size_t)3);
}

// What one warp knows of its doc while it applies the doc's ops.
struct Doc {
  int S;
  int lane;
  int wid;             // this warp's index within its doc
  int W;               // warps per doc
  int base;            // this lane's first slot
  int32_t* table;      // [NS][ROW] prop entries, by row
  int32_t* ts;         // [NS] text_start, by row
  int32_t* flags;      // [NS] flags, by row
  int32_t* comb;       // multi-warp: W combine rows
  int32_t* free_rows;  // multi-warp: rows handed over by a shift
  int32_t count;
  bool ovf;            // third remover / full prop table at a slot
};

// One real op on a doc whose VIS and CUM this op's perspective has just
// set: an insert (INS) or a remove / annotate. Returns false when the op
// is refused (bad position, or no room for the slots it adds); the state
// is then unchanged.
template <int SPT, bool MULTI, bool INS>
__device__ __forceinline__ bool apply_op(
    int32_t (&v)[N_VAL][SPT], Doc& dc, const int32_t* op, int32_t pos,
    int32_t end, int32_t seq, int32_t client, int32_t total) {
  const int S = dc.S, lane = dc.lane, base = dc.base;
  const int32_t p2 = INS ? pos : end;

  // ---- first-True indices and split extracts: an in-lane pass, then
  // warp reductions. A position lies strictly inside at most one visible
  // segment, so the sums pick one slot's values, as the plain masked sums
  // do. Inserts need j1, idx0 (the earliest boundary at pos), c1, l1;
  // removes and annotates j1, j2, c1, l1, c2, l2.
  constexpr int NR = INS ? 4 : 6;
  constexpr int NMIN = 2;
  int32_t r[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) r[q] = q < NMIN ? S : 0;
#pragma unroll
  for (int i = SPT - 1; i >= 0; --i) {  // descending: the first one wins
    const int s = base + i;
    const int32_t cum = v[CUM][i];
    const int32_t inc = cum + (v[VIS][i] ? v[LEN][i] : 0);
    if (v[VIS][i] && cum < pos && pos < inc) {
      r[0] = s; r[2] += cum; r[3] += v[LEN][i];
    }
    if constexpr (INS) {
      // the earliest boundary at pos; a slot past S is picked only when
      // every used slot ends before pos, and then the op is refused
      if (cum >= pos) r[1] = s;
    } else {
      if (v[VIS][i] && cum < p2 && p2 < inc) {
        r[1] = s; r[4] += cum; r[5] += v[LEN][i];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NR; ++q)
    r[q] = q < NMIN ? __reduce_min_sync(FULL, r[q])
                    : __reduce_add_sync(FULL, r[q]);
  if constexpr (MULTI) {
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < NR; ++q) dc.comb[dc.wid * COMB + C_RED + q] = r[q];
    }
    __syncthreads();  // combine 2: reductions
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const int32_t t = lane < dc.W ? dc.comb[lane * COMB + C_RED + q]
                                    : (q < NMIN ? S : 0);
      r[q] = q < NMIN ? __reduce_min_sync(FULL, t)
                      : __reduce_add_sync(FULL, t);
    }
  }
  const int32_t j1 = r[0];
  const int32_t c1 = r[2], l1 = r[3];
  const int32_t j2 = INS ? S : r[1];
  const int32_t idx0 = INS ? r[1] : S;
  const int32_t c2 = INS ? 0 : r[NR - 2], l2 = INS ? 0 : r[NR - 1];

  const bool bad_shape = INS ? pos > total : (end > total || end <= pos);
  const bool s1 = j1 < S;
  const bool s2 = !INS && j2 < S;
  const int added = (int)s1 + (int)s2 + (int)INS;
  if (bad_shape || dc.count + added > S) return false;
  if (!added) return true;  // a remove / annotate on whole segments
  const int32_t o1 = pos - c1, o2 = p2 - c2;
  const bool same = s1 && s2 && j1 == j2;
  const int32_t s1i = s1 ? 1 : 0;
  const int32_t p_ins = s1 ? j1 + 1 : idx0;  // inserts only
  const int32_t p_n1 = INS ? p_ins + 1 : j1 + 1;
  const int32_t p_h2 = j2 + s1i;
  const int32_t p_n2 = j2 + 1 + s1i;

  // ---- shift by 0/1/2 in registers; inserts leave VIS and CUM behind
  // (nothing reads them after an insert)
  constexpr int NQ = INS ? PROW + 1 : N_VAL;
  const bool two = added == 2;
  const int ja = INS ? p_ins : (s1 ? p_n1 : p_n2);
  const int jb = INS ? p_n1 : p_n2;
  int32_t p1[N_VAL], p2v[N_VAL];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    p1[q] = __shfl_up_sync(FULL, v[q][SPT - 1], 1);
    p2v[q] = 0;
  }
  if (two) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      p2v[q] = SPT >= 2 ? __shfl_up_sync(FULL, v[q][SPT >= 2 ? SPT - 2 : 0], 1)
                        : __shfl_up_sync(FULL, v[q][0], 2);
  }
  // the rows of the last two slots (of all 32*SPT*W), which the shift
  // drops: each new slot takes one
  int32_t fr0, fr1;
  if constexpr (MULTI) {
    int32_t* bnd = dc.comb + dc.wid * COMB + C_BND;
    if (lane == 31) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        bnd[2 * q] = v[q][SPT - 1];
        bnd[2 * q + 1] = v[q][SPT - 2];
      }
    }
    if (lane == 31 && dc.wid == dc.W - 1) {
      dc.free_rows[0] = v[PROW][SPT - 1];
      dc.free_rows[1] = v[PROW][SPT - 2];
    }
    __syncthreads();  // combine 3: shift boundaries and free rows
    if (lane == 0 && dc.wid > 0) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        p1[q] = bnd[2 * q - COMB];
        p2v[q] = bnd[2 * q + 1 - COMB];
      }
    }
    fr0 = dc.free_rows[0];
    fr1 = dc.free_rows[1];
  } else {
    fr0 = __shfl_sync(FULL, v[PROW][SPT - 1], 31);
    fr1 = SPT >= 2 ? __shfl_sync(FULL, v[PROW][SPT >= 2 ? SPT - 2 : 0], 31)
                   : __shfl_sync(FULL, v[PROW][0], 30);
  }
  if (two) shift_values<SPT, NQ, true>(v, base, ja, jb, p1, p2v);
  else shift_values<SPT, NQ, false>(v, base, ja, jb, p1, p2v);

  // ---- point patches, in the plain rebuild's order (later ones win).
  // The insert takes the first free row, a split tail the first not
  // taken before it in slot order. The split sources j1 and j2 keep their
  // rows; old j2 now sits at p_h2 (at j1 when both splits are in one
  // segment).
  const int32_t fr_n1 = INS ? fr1 : fr0;
  const int32_t fr_n2 = s1 ? fr1 : fr0;
  const int32_t p_src2 = same ? j1 : p_h2;
  int32_t m_src1 = 0, m_src2 = 0;
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = base + i;
    const bool head1_at = s1 && s == j1;
    const bool n1_at = s1 && s == p_n1;
    if (head1_at) m_src1 = v[PROW][i];
    if (!INS && s2 && s == p_src2) m_src2 = v[PROW][i];
    if (head1_at) v[LEN][i] = o1;
    if constexpr (INS) {
      if (n1_at) { v[LEN][i] = l1 - o1; v[PROW][i] = fr_n1; }
      if (s == p_ins) {
        const int32_t tlen = op[F_TLEN];
        v[LEN][i] = tlen > 0 ? tlen : 1;
        v[ISEQ][i] = seq;
        v[ICL][i] = client;
        v[RSEQ][i] = NO_SEQ;
        v[RCA][i] = NO_CLIENT;
        v[RCB][i] = NO_CLIENT;
        v[PROW][i] = fr0;
      }
    } else {
      const bool h2_at = s2 && !same && s == p_h2;
      const bool n2_at = s2 && s == p_n2;
      if (n1_at) {
        v[LEN][i] = same ? o2 - o1 : l1 - o1;
        v[CUM][i] = c1 + o1; v[PROW][i] = fr_n1;
      }
      if (h2_at) v[LEN][i] = o2;
      if (n2_at) {
        v[LEN][i] = l2 - o2;
        v[CUM][i] = c2 + o2; v[PROW][i] = fr_n2;
      }
    }
  }
  dc.count += added;
  int32_t src1, src2;
  if constexpr (MULTI) {
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = base + i;
      if (s1 && s == j1) dc.free_rows[2] = m_src1;
      if (!INS && s2 && s == p_src2) dc.free_rows[3] = m_src2;
    }
    __syncthreads();  // combine 3b: the split sources' rows
    src1 = dc.free_rows[2];
    src2 = dc.free_rows[3];
  } else {
    src1 = __shfl_sync(FULL, m_src1, min(j1, S - 1) / SPT);
    src2 = __shfl_sync(FULL, m_src2, min(p_src2, S - 1) / SPT);
  }

  // ---- the new slots' rows, one prop entry a lane: lanes 0-15 copy the
  // first split's tail, lanes 16-31 copy the second's or clear the
  // insert's; lanes 0 and 16 also set the row's text_start (the source's
  // plus the split offset, or the insert's) and flags. Sources are live
  // rows and destinations free ones, so no lane reads what another
  // writes here.
  if constexpr (!MULTI) __syncwarp();  // earlier prop writes land
  {
    const int e = lane & (ROW - 1);
    const bool lo = lane < ROW;
    const bool act = (!MULTI || dc.wid == 0) && (lo ? s1 : (INS || s2));
    if (act) {
      const int32_t dst = lo ? fr_n1 : (INS ? fr0 : fr_n2);
      const int32_t src = lo ? src1 : src2;
      const bool clear = INS && !lo;
      dc.table[dst * ROW + e] = clear ? (e < P ? NO_KEY : 0)
                                      : dc.table[src * ROW + e];
      if (e == 0) {
        dc.ts[dst] = clear ? op[F_TSTART] : dc.ts[src] + (lo ? o1 : o2);
        dc.flags[dst] = clear ? op[F_FLAGS] : dc.flags[src];
      }
    }
  }
  return true;
}

// The covered slots of a remove (stamps) or an annotate (prop writes),
// on the shifted VIS / CUM.
template <int SPT, bool MULTI>
__device__ __forceinline__ void cover_op(
    int32_t (&v)[N_VAL][SPT], Doc& dc, const int32_t* op, int32_t pos,
    int32_t end, int32_t seq, int32_t client, bool is_rem) {
  if (is_rem) {
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int32_t cum = v[CUM][i];
      const int32_t vlen = v[VIS][i] ? v[LEN][i] : 0;
      const bool covered = v[VIS][i] && cum >= pos && cum + vlen <= end;
      const bool fresh = covered && v[RSEQ][i] == NO_SEQ;
      // overlap: ops apply in seq order, so the existing stamp is the
      // earliest; record this client as an extra remover
      const bool over = covered && !fresh && v[RCA][i] != client;
      const bool add_b = over && v[RCB][i] == NO_CLIENT;
      dc.ovf |= over && !add_b && v[RCB][i] != client;  // a third one
      if (fresh) { v[RSEQ][i] = seq; v[RCA][i] = client; }
      if (add_b) v[RCB][i] = client;
    }
    return;
  }
  // annotate: per-key last writer wins. The row copies land before any
  // covered slot's props are read.
  if constexpr (MULTI) __syncthreads();  // combine 4
  else __syncwarp();
  const int32_t key = op[F_KEY], val = op[F_VAL];
  const bool is_delete = val == NO_VAL;
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int32_t cum = v[CUM][i];
    const int32_t vlen = v[VIS][i] ? v[LEN][i] : 0;
    const bool covered = v[VIS][i] && cum >= pos && cum + vlen <= end;
    if (covered) {
      int32_t* t = dc.table + v[PROW][i] * ROW;
      const int4 ka = reinterpret_cast<const int4*>(t)[0];
      const int4 kb = reinterpret_cast<const int4*>(t)[1];
      const int32_t pk[P] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
      int tm = P, te = P;
#pragma unroll
      for (int p = P - 1; p >= 0; --p) {
        if (pk[p] == key) tm = p;
        if (pk[p] == NO_KEY) te = p;
      }
      const bool has_key = tm < P, has_empty = te < P;
      if (has_key || (!is_delete && has_empty)) {
        const int tgt = has_key ? tm : te;
        t[tgt] = is_delete ? NO_KEY : key;
        t[P + tgt] = is_delete ? 0 : val;
      } else if (!is_delete) {
        dc.ovf = true;  // a (P+1)th distinct key: escalate
      }
    }
  }
}

// Register cap: 3 CTAs of MAX_THREADS threads a SM (168 registers), which
// shared memory allows at S = 256 too.
template <int SPT, bool MULTI>
__global__ void __launch_bounds__(MAX_THREADS, 3) apply_kernel(Args a) {
  extern __shared__ __align__(16) int32_t smem[];
  const int S = a.S;
  const int K = a.K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int docs_per_cta = MULTI ? 1 : nwarps;
  const int local_doc = MULTI ? 0 : warp;
  const int d = blockIdx.x * docs_per_cta + local_doc;
  if (!MULTI && d >= a.D) return;  // a spare warp of the last CTA

  Doc dc;
  dc.S = S;
  dc.lane = lane;
  dc.wid = MULTI ? warp : 0;
  dc.W = MULTI ? nwarps : 1;
  dc.base = (dc.wid * 32 + lane) * SPT;
  const int NS = 32 * SPT * dc.W;  // slots, inert ones past S included
  const size_t doc_ints = doc_shared_ints(NS);
  dc.table = smem + local_doc * doc_ints;
  dc.ts = dc.table + (size_t)NS * ROW;
  dc.flags = dc.ts + NS;
  int32_t* opbuf = smem + docs_per_cta * doc_ints + warp * OPBUF;
  dc.comb = smem + docs_per_cta * doc_ints + nwarps * OPBUF;
  dc.free_rows = dc.comb + dc.W * COMB;
  const int base = dc.base;

  // ---- load: the prop tables (coalesced) and the slots into registers
  {
    const size_t off = (size_t)d * S * P;
    const int stride = MULTI ? blockDim.x : 32;
    for (int e = MULTI ? threadIdx.x : lane; e < S * P; e += stride) {
      const int r = e / P, p = e % P;
      dc.table[r * ROW + p] = __ldg(a.in_pk + off + e);
      dc.table[r * ROW + P + p] = __ldg(a.in_pv + off + e);
    }
    for (int e = MULTI ? threadIdx.x : lane; e < S; e += stride) {
      dc.ts[e] = __ldg(a.in[F_TS] + (size_t)d * S + e);
      dc.flags[e] = __ldg(a.in[F_FL] + (size_t)d * S + e);
    }
  }
  int32_t v[N_VAL][SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = base + i;
    if (s < S) {
      const size_t g = (size_t)d * S + s;
#pragma unroll
      for (int q = 0; q < N_REG; ++q) v[q][i] = __ldg(a.in[field_of(q)] + g);
      v[PROW][i] = s;
    } else {  // inert slot: never visible, written or a source of a slot
      // below S; its row holds nothing until a shift hands it out
      v[LEN][i] = 0; v[ISEQ][i] = 0;
      v[ICL][i] = NO_CLIENT; v[RSEQ][i] = NO_SEQ; v[RCA][i] = NO_CLIENT;
      v[RCB][i] = NO_CLIENT; v[PROW][i] = s;
    }
    v[VIS][i] = 0;
    v[CUM][i] = 0;
  }
  dc.count = a.in_count[d];
  dc.ovf = false;
  bool bad_any = false;  // uniform across the doc
  if constexpr (MULTI) __syncthreads();  // the table is shared by the doc's warps

  const int32_t* ops = a.ops + (size_t)d * K * OP_FIELDS;
  for (int k = 0; k < K; ++k) {
    if (k % OP_CHUNK == 0) {  // stage the next op rows for this warp
      __syncwarp();
      const int n = min(OP_CHUNK, K - k) * OP_FIELDS;
      const int32_t* src = ops + (size_t)k * OP_FIELDS;
      for (int e = lane; e < n; e += 32) opbuf[e] = __ldg(src + e);
      __syncwarp();
    }
    const int32_t* op = opbuf + (k % OP_CHUNK) * OP_FIELDS;
    const int32_t typ = op[F_TYPE];
    const bool is_ins = typ == OP_INSERT;
    const bool is_rem = typ == OP_REMOVE;
    const bool is_ann = typ == OP_ANNOTATE;
    if (!(is_ins || is_rem || is_ann)) continue;  // NOOP: state unchanged
    const int32_t pos = op[F_POS], end = op[F_END];
    const int32_t seq = op[F_SEQ], ref = op[F_REFSEQ];
    const int32_t client = op[F_CLIENT];

    // ---- visibility at (ref, client) and the exclusive prefix sum: an
    // in-lane scan, then a shuffle scan across the warp
    int32_t run = 0;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const bool in_use = base + i < dc.count;  // count <= S
      const bool ins_seen = (v[ICL][i] == client) || (v[ISEQ][i] <= ref);
      const bool removed = (v[RSEQ][i] != NO_SEQ) &&
          (v[RCA][i] == client || v[RCB][i] == client || v[RSEQ][i] <= ref);
      const bool vis = in_use && ins_seen && !removed;
      v[VIS][i] = vis ? 1 : 0;
      run += vis ? v[LEN][i] : 0;
    }
    int32_t x = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += y;
    }
    int32_t prefix = 0;
    int32_t total = __shfl_sync(FULL, x, 31);
    if constexpr (MULTI) {
      if (lane == 31) dc.comb[dc.wid * COMB + C_TOT] = x;
      __syncthreads();  // combine 1: warp totals
      const int32_t t = lane < dc.W ? dc.comb[lane * COMB + C_TOT] : 0;
      prefix = __reduce_add_sync(FULL, lane < dc.wid ? t : 0);
      total = __reduce_add_sync(FULL, t);
    }
    {
      int32_t c = prefix + x - run;
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        v[CUM][i] = c;
        c += v[VIS][i] ? v[LEN][i] : 0;
      }
    }

    if (is_ins) {
      bad_any |= !apply_op<SPT, MULTI, true>(v, dc, op, pos, end, seq,
                                             client, total);
    } else if (apply_op<SPT, MULTI, false>(v, dc, op, pos, end, seq, client,
                                           total)) {
      cover_op<SPT, MULTI>(v, dc, op, pos, end, seq, client, is_rem);
    } else {
      bad_any = true;  // refused: only the sticky flag changes
    }
  }

  // ---- write back: slot fields from registers, text_start and flags
  // through the rows; then the rows go where text_start and flags were,
  // and the props follow them, coalesced
  bool ovf_any;
  if constexpr (MULTI) ovf_any = __syncthreads_or(dc.ovf) != 0;
  else ovf_any = __any_sync(FULL, dc.ovf);
  __syncwarp();  // every prop write of this warp has landed
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = base + i;
    if (s < S) {
      const size_t g = (size_t)d * S + s;
#pragma unroll
      for (int q = 0; q < N_REG; ++q) a.out[field_of(q)][g] = v[q][i];
      a.out[F_TS][g] = dc.ts[v[PROW][i]];
      a.out[F_FL][g] = dc.flags[v[PROW][i]];
    }
  }
  int32_t* rows = dc.ts;  // [S]: free once text_start and flags are out
  if constexpr (MULTI) __syncthreads();
  else __syncwarp();
#pragma unroll
  for (int i = 0; i < SPT; ++i)
    if (base + i < S) rows[base + i] = v[PROW][i];
  if constexpr (MULTI) __syncthreads();
  else __syncwarp();
  {
    const size_t off = (size_t)d * S * P;
    const int stride = MULTI ? blockDim.x : 32;
    for (int e = MULTI ? threadIdx.x : lane; e < S * P; e += stride) {
      const int rw = rows[e / P], p = e % P;
      a.out_pk[off + e] = dc.table[rw * ROW + p];
      a.out_pv[off + e] = dc.table[rw * ROW + P + p];
    }
  }
  if (threadIdx.x == (MULTI ? 0 : warp * 32)) {
    a.out_count[d] = dc.count;
    a.out_ovf[d] = (a.in_ovf[d] != 0 || bad_any || ovf_any) ? 1 : 0;
  }
}

// Shared memory of one CTA, in bytes: the mirror of
// ops/cuda_apply.py::launch_geometry (which the wrapper passes in).
size_t smem_needed(int slots_per_lane, int warps_per_doc, int docs_per_cta) {
  size_t ints = (size_t)docs_per_cta *
                    doc_shared_ints(32 * slots_per_lane * warps_per_doc)
                + (size_t)docs_per_cta * warps_per_doc * OPBUF;
  if (warps_per_doc > 1) ints += (size_t)warps_per_doc * COMB + 4;
  return ints * sizeof(int32_t);
}

template <int SPT, bool MULTI>
cudaError_t launch(const Args& a, int threads, int blocks, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        apply_kernel<SPT, MULTI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  apply_kernel<SPT, MULTI><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Applies a [D, K, 12] int32 wave to D docs: reads the 12 input state
// planes, writes the 12 output planes (distinct buffers). The geometry
// (slots per lane, warps per doc, docs per CTA, shared bytes) comes from
// ops/cuda_apply.py::launch_geometry and is checked here. Launches on
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
    int D, int S, int P_, int K,
    int slots_per_lane, int warps_per_doc, int docs_per_cta, int smem_bytes,
    void* stream) {
  // P is a compile-time constant (the port's doc state uses P = 8)
  if (D <= 0 || K < 0 || S <= 0 || P_ != P) return (int)cudaErrorInvalidValue;
  const bool multi = warps_per_doc > 1;
  const int threads = 32 * warps_per_doc * docs_per_cta;
  if (slots_per_lane * 32 * warps_per_doc < S || threads > MAX_THREADS ||
      (multi && (docs_per_cta != 1 || slots_per_lane != 8)) ||
      (!multi && warps_per_doc != 1) || docs_per_cta < 1 ||
      smem_bytes < 0 ||
      (size_t)smem_bytes < smem_needed(slots_per_lane, warps_per_doc,
                                       docs_per_cta))
    return (int)cudaErrorInvalidValue;
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
  a.D = D;
  a.S = S;
  a.K = K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (D + docs_per_cta - 1) / docs_per_cta;
  const size_t smem = (size_t)smem_bytes;
  if (multi) return (int)launch<8, true>(a, threads, blocks, smem, st);
  switch (slots_per_lane) {
    case 1: return (int)launch<1, false>(a, threads, blocks, smem, st);
    case 2: return (int)launch<2, false>(a, threads, blocks, smem, st);
    case 4: return (int)launch<4, false>(a, threads, blocks, smem, st);
    case 8: return (int)launch<8, false>(a, threads, blocks, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
