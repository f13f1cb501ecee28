// Anti-diagonal wavefront window scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rafft_tpu/engine/wavefront.py:_kernel
// (launched by _wavefront_call, wrapped by wavefront_tables).  For every
// beam row, region and anti-diagonal lag = ip + jp of the region-local
// pair matrix it runs the reference's window-slide recurrence and writes
// seven per-lag tables: the raw correlation cor_raw (sum of pair weights
// along the diagonal) and, for the best run inside the half-window, its
// length, innermost pair, stacked-pair energy and Zobrist hash deltas.
// The output equals the Pallas kernel entry for entry over the whole
// [rows, R, 2N] table, padding entries and zeroed tail included.
//
// What bounds it on this card.  Bytes: a region of m positions reads 4m+1
// and writes 7 * 2N int32, and most of the R slots of a beam row are empty
// or short, so the cells that carry information (m * m for a region) are
// few beside the 56 N bytes of stores.  The floor is the card's memory
// rate over those bytes; the arithmetic (66 operations per cell inside the
// half-window, 6 per cell past it) is below it at every shape the fold
// step uses.  Tensor cores, TMA and wgmma have nothing to offer a scalar
// integer recurrence along a diagonal, so this is plain SIMT code.
//
// Design.
// * Only the region's own m x m cells run the recurrence.  A padding cell
//   (code 0, position N) has weight 0: it resets the run and can only move
//   (max_i, max_j) of a lag that has met no region cell yet, which is a
//   closed form in c = the number of region positions < N - min_hp
//   (rafft_tpu_torch/engine/wavefront.py states and tests it).  An empty
//   slot costs its stores and one load of its length.
// * Balanced diagonals.  Lane t of a region walks lag t (cells ip = 0..t)
//   and then lag t+m (cells ip = t+1..m-1): m cells for every lane, and in
//   iteration `it` every lane is at row ip = it, so the row's values are
//   one broadcast read and the column's (jp = (t - it) mod m) are
//   conflict-free.  The values of the previous cell (ip-1, jp+1) stay in
//   registers.
// * A short chain of lookups per cell.  The SM's load/store path is full
//   of the block's own and its neighbours' stores, so the dependent
//   shared-memory lookups of a cell (codes, then pair types, then stack
//   energy) set the pace of the walk, not its arithmetic.  The stack
//   energy is one lookup in a 25 x 25 table of code pairs, and the next
//   cell's codes are loaded one iteration ahead, so a cell waits for one
//   round of lookups (on an H100 a lone region of 1016 positions walks at
//   0.12 us per iteration beside the kernel's stores, 0.16 us without
//   these two measures).
// * Half the cells are cheap.  The window state can change only while
//   ip - lo < half; once every lane of a warp is past that, the warp adds
//   the pair weight to the correlation and skips the rest.
// * A block is 128 lanes over four consecutive regions.  It reads their
//   lengths at once, writes the lags without region cells of all four
//   (28 KB of 16-byte stores behind one round of loads, no barrier), and
//   then walks those of the four that are not empty one after the other.
//   A region longer than 128 is split over gridDim.y blocks, so no block
//   runs more than m iterations of four warps per region and a long region
//   spreads over several SMs.  A block takes 16 N bytes of shared memory,
//   so several fit one SM.  The region is staged with 16-byte loads; its
//   own lags are stored from registers after the loop, one lag per lane
//   (coalesced).
// * c needs no reduction: positions ascend and are distinct, so only the
//   last min_hp entries of a region can be >= N - min_hp.
//
// Exactness.  tot = (tot_p + w) * w is one IEEE add and one IEEE multiply
// (__fadd_rn/__fmul_rn, and the library is built with --fmad=false); the
// correlation is summed in diagonal order; hashes are uint32 arithmetic
// mod 2^32.  The half-window of a lag with len region cells is
// ceil(len / 2); lags past 2m-2 have none, so the floor division of the
// negative width that the reference needs there never arises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;   // threads per block: lanes of one region
constexpr int kTables = 7;

struct Tables {
  int* p[kTables];  // cor_raw (f32 bits), max_nb, max_i, max_j, best_sE, hd1, hd2
};

constexpr int kGroup = 4;     // consecutive regions per block
constexpr int kQuads = 2 * kLanes / 4;  // 16-byte stores per table and stripe

// c = the region positions < N - min_hp: all but some of the last min_hp
__device__ __forceinline__ int hairpin_prefix(const int* __restrict__ pos,
                                              int m, int N, int min_hp) {
  int c = m;
  for (int j = 0; j < min_hp && j < m; ++j) c -= pos[m - 1 - j] >= N - min_hp;
  return c;
}

// max_i (which = 0) or max_j (which = 1) of a lag L >= 2m-1, which has no
// region cell on its diagonal
__device__ __forceinline__ int pad_entry(int which, int L, int c, int N) {
  const bool ok = (c >= 1) && (L <= N + c - 2);
  return ok ? (which ? L - c + 1 : c - 1) : 0;
}

// the lags >= pad0 of one table inside the 4 lags from L on
__device__ __forceinline__ void store_pad(int* __restrict__ dst, int L,
                                          int pad0, int N, bool vec_ok,
                                          int4 v) {
  if (vec_ok && L >= pad0 && L + 3 < 2 * N) {
    *reinterpret_cast<int4*>(dst) = v;
  } else {
    if (L >= pad0 && L < 2 * N) dst[0] = v.x;
    if (L + 1 >= pad0 && L + 1 < 2 * N) dst[1] = v.y;
    if (L + 2 >= pad0 && L + 2 < 2 * N) dst[2] = v.z;
    if (L + 3 >= pad0 && L + 3 < 2 * N) dst[3] = v.w;
  }
}

__global__ void __launch_bounds__(kLanes) wavefront_kernel(
    const int* __restrict__ rcodes, const int* __restrict__ rpos,
    const int* __restrict__ mlen, const int* __restrict__ z1row,
    const int* __restrict__ z2row, const float* __restrict__ Wg,
    const int* __restrict__ SEg, Tables out, int regions, int N, int min_hp) {
  extern __shared__ __align__(16) int smem[];
  int* s_codes = smem;
  int* s_pos = smem + N;
  uint32_t* s_z1 = reinterpret_cast<uint32_t*>(smem + 2 * N);
  uint32_t* s_z2 = reinterpret_cast<uint32_t*>(smem + 3 * N);
  __shared__ float s_W[25];
  __shared__ int s_SE[625];

  const int region0 = blockIdx.x * kGroup;  // region = beam row * R + slot
  const int ng = min(kGroup, regions - region0);
  const int tid = threadIdx.x;
  const int t0 = blockIdx.y * kLanes;

  // ---- the four lengths and hairpin prefixes, loaded together
  int mm[kGroup], cc[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
    mm[g] = g < ng ? min(max(mlen[region0 + g], 0), N) : 0;
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
    cc[g] = hairpin_prefix(rpos + static_cast<size_t>(region0 + g) * N, mm[g],
                           N, min_hp);
  const int m_max = max(max(mm[0], mm[1]), max(mm[2], mm[3]));

  // ---- the lags without region cells: this block's stripe of 2 * kLanes
  // lags in each region.  Lane pair (q, hi) writes 4 lags of tables 2j + hi.
  const bool vec_ok = (N & 1) == 0;  // 2N * 4 bytes keep 16-byte alignment
  const int q = tid % kQuads, hi = tid / kQuads;
  const int Lq = 2 * t0 + 4 * q;
  if (Lq < 2 * N) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (g >= ng) break;
      const int pad0 = max(2 * mm[g] - 1, 0);
      if (Lq + 3 < pad0) continue;
      const size_t o = static_cast<size_t>(region0 + g) * 2 * N + Lq;
      const int c = cc[g];
      const int4 zero = make_int4(0, 0, 0, 0);
      const int4 ij = make_int4(pad_entry(hi, Lq, c, N), pad_entry(hi, Lq + 1, c, N),
                                pad_entry(hi, Lq + 2, c, N), pad_entry(hi, Lq + 3, c, N));
      store_pad((hi ? out.p[1] : out.p[0]) + o, Lq, pad0, N, vec_ok, zero);
      store_pad((hi ? out.p[3] : out.p[2]) + o, Lq, pad0, N, vec_ok, ij);
      store_pad((hi ? out.p[5] : out.p[4]) + o, Lq, pad0, N, vec_ok, zero);
      if (!hi) store_pad(out.p[6] + o, Lq, pad0, N, vec_ok, zero);
    }
  }
  if (t0 >= m_max) return;  // no lane of these regions in this block

  if (tid < 25) s_W[tid] = Wg[tid];
  for (int x = tid; x < 625; x += kLanes) s_SE[x] = SEg[x];

  // ---- the regions' own lags: lane t walks lag t, then lag t + m
  const int t = t0 + tid;
  for (int g = 0; g < ng; ++g) {
    const int m = min(max(mlen[region0 + g], 0), N);
    if (t0 >= m) continue;
    const size_t in_base = static_cast<size_t>(region0 + g) * N;
    const size_t out_base = 2 * in_base;
    const int c = hairpin_prefix(rpos + in_base, m, N, min_hp);
    __syncthreads();  // the previous region's walk is over
    if ((N & 3) == 0) {
      const int4* g_codes = reinterpret_cast<const int4*>(rcodes + in_base);
      const int4* g_pos = reinterpret_cast<const int4*>(rpos + in_base);
      const int4* g_z1 = reinterpret_cast<const int4*>(z1row + in_base);
      const int4* g_z2 = reinterpret_cast<const int4*>(z2row + in_base);
      for (int x = tid; x < (m + 3) / 4; x += kLanes) {
        reinterpret_cast<int4*>(s_codes)[x] = g_codes[x];
        reinterpret_cast<int4*>(s_pos)[x] = g_pos[x];
        reinterpret_cast<int4*>(s_z1)[x] = g_z1[x];
        reinterpret_cast<int4*>(s_z2)[x] = g_z2[x];
      }
    } else {
      for (int x = tid; x < m; x += kLanes) {
        s_codes[x] = rcodes[in_base + x];
        s_pos[x] = rpos[in_base + x];
        s_z1[x] = static_cast<uint32_t>(z1row[in_base + x]);
        s_z2[x] = static_cast<uint32_t>(z2row[in_base + x]);
      }
    }
    __syncthreads();

    const bool lane = t < m;
    float tot = 0.f, cor = 0.f, ms = 0.f;
    int tmp = 0, sE = 0, nb = 0, mi = 0, mj = 0, bsE = 0;
    uint32_t hd1 = 0u, hd2 = 0u, bh1 = 0u, bh2 = 0u;
    float a_cor = 0.f;
    int a_nb = 0, a_mi = 0, a_mj = 0, a_sE = 0;
    uint32_t a_h1 = 0u, a_h2 = 0u;
    int L = t, lo = 0, half = (t + 2) >> 1;
    int c5m = 0, c3p = 0, p5m = -9, p3p = -9;  // the cell before: (ip-1, jp+1)
    // Row ip = it is the same for every lane, column jp = (t - it) mod m.
    // The codes and positions of the next cell are loaded one iteration
    // ahead, so that this cell's table lookups can start at once.
    int jp = lane ? t : 0;
    int c5 = s_codes[0], p5 = s_pos[0], c3 = s_codes[jp], p3 = s_pos[jp];

    for (int it = 0; it < m; ++it) {
      const int ip = it;
      const int ip_n = min(it + 1, m - 1);
      const int jp_n = lane ? (jp ? jp - 1 : m - 1) : 0;
      const int c5_n = s_codes[ip_n], p5_n = s_pos[ip_n];
      const int c3_n = s_codes[jp_n], p3_n = s_pos[jp_n];
      const unsigned lw = static_cast<unsigned>(c5 * 5 + c3);
      const float w = lw < 25u ? s_W[lw] : 0.f;
      if (it == t + 1) {
        // lag t is complete; lag t + m starts from the closed form of its
        // leading padding cells (jp >= m)
        a_cor = cor; a_nb = nb; a_mi = mi; a_mj = mj; a_sE = bsE;
        a_h1 = bh1; a_h2 = bh2;
        tot = cor = ms = 0.f;
        tmp = sE = nb = bsE = 0;
        hd1 = hd2 = bh1 = bh2 = 0u;
        L = t + m;
        lo = t + 1;
        half = (m - t) >> 1;
        const int last = min(t, c - 1);
        const bool ok = (c >= 1) && (m < N) && (last >= max(L - N + 1, 0));
        mi = ok ? last : 0;
        mj = ok ? L - last : 0;
        c3p = 0;
        p3p = -9;
      }
      const bool inwin = lane && (ip - lo < half);
      if (__any_sync(0xffffffffu, inwin)) {
        // stack energy between outer pair (ip-1, jp+1) and inner (ip, jp)
        const unsigned la = static_cast<unsigned>(c5m * 5 + c3p);
        const unsigned lb = static_cast<unsigned>(c3 * 5 + c5);
        const int e = (la < 25u && lb < 25u) ? s_SE[la * 25 + lb] : 0;
        const uint32_t z1i = s_z1[ip], z1j = s_z1[jp];
        const uint32_t z2i = s_z2[ip], z2j = s_z2[jp];
        const bool contig = (ip > lo) && (p5 - p5m == 1) && (p3p - p3 == 1);
        const float tot_p = tot;
        tot = contig ? __fmul_rn(__fadd_rn(tot_p, w), w) : w;
        tmp = tot == 0.f ? 0 : tmp + 1;
        const bool in_run = (tot != 0.f) && (tot_p != 0.f) && contig;
        sE = (tot == 0.f || tot_p == 0.f) ? 0 : (in_run ? sE + e : sE);
        // hash delta of pairing (p5, p3): Z[p5]*(p3+1) + Z[p3]*(p5+1)
        const uint32_t a3 = static_cast<uint32_t>(p3 + 1);
        const uint32_t a5 = static_cast<uint32_t>(p5 + 1);
        hd1 = tot == 0.f ? 0u : hd1 + z1i * a3 + z1j * a5;
        hd2 = tot == 0.f ? 0u : hd2 + z2i * a3 + z2j * a5;
        if (inwin && ((p3 - p5) > min_hp) && (tot >= ms)) {
          ms = tot;
          nb = tmp;
          mi = ip;
          mj = jp;
          bsE = sE;
          bh1 = hd1;
          bh2 = hd2;
        }
      }
      cor = __fadd_rn(cor, w);
      c5m = c5;
      p5m = p5;
      c3p = c3;
      p3p = p3;
      c5 = c5_n;
      p5 = p5_n;
      c3 = c3_n;
      p3 = p3_n;
      jp = jp_n;
    }
    if (!lane) continue;
    // lane m-1 ends on lag m-1 (it has no second lag); every lane before
    // it holds lag t in a_* and lag t + m in the running state
    const bool second = t < m - 1;
    if (!second) {
      a_cor = cor; a_nb = nb; a_mi = mi; a_mj = mj; a_sE = bsE;
      a_h1 = bh1; a_h2 = bh2;
    }
    const size_t oa = out_base + t;
    out.p[0][oa] = __float_as_int(a_cor);
    out.p[1][oa] = a_nb;
    out.p[2][oa] = a_mi;
    out.p[3][oa] = a_mj;
    out.p[4][oa] = a_sE;
    out.p[5][oa] = static_cast<int>(a_h1);
    out.p[6][oa] = static_cast<int>(a_h2);
    if (second) {
      const size_t ob = out_base + t + m;
      out.p[0][ob] = __float_as_int(cor);
      out.p[1][ob] = nb;
      out.p[2][ob] = mi;
      out.p[3][ob] = mj;
      out.p[4][ob] = bsE;
      out.p[5][ob] = static_cast<int>(bh1);
      out.p[6][ob] = static_cast<int>(bh2);
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers to contiguous int32 / float32 arrays: rcodes, rpos, z1row,
// z2row [regions, N]; mlen [regions]; W [25] f32; SE [625] (the stack
// energy between the pairs of code pairs la and lb at la * 25 + lb, 0 where
// either is no pair); outputs [regions, 2N].  regions = beam rows * R.  Launches on
// `stream` and returns the cudaError_t of the launch (0 on success).
extern "C" int rafft_wavefront(
    const int* rcodes, const int* rpos, const int* mlen, const int* z1row,
    const int* z2row, const float* W, const int* SE, float* cor, int* nb, int* mi, int* mj, int* sE, int* hd1, int* hd2,
    int regions, int N, int min_hp, void* stream) {
  if (regions <= 0 || N <= 0) return 0;
  if (min_hp < 0) return static_cast<int>(cudaErrorInvalidValue);
  // one region's four rows: 16 N bytes, 32 KiB at N = 2048 and 64 KiB at
  // N = 4096, which is past the 48 KiB a kernel gets without opting in
  const size_t smem = 4 * static_cast<size_t>(N) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Tables out{{reinterpret_cast<int*>(cor), nb, mi, mj, sE, hd1, hd2}};
  const dim3 grid((regions + kGroup - 1) / kGroup, (N + kLanes - 1) / kLanes);
  wavefront_kernel<<<grid, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      rcodes, rpos, mlen, z1row, z2row, W, SE, out, regions, N, min_hp);
  return static_cast<int>(cudaGetLastError());
}
