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
// [rows, R, 2N] table: lag L is finalised at row min(L, mmax-1), where
// mmax is the longest region of the beam row, and lags >= mmax+N-1 are 0.
//
// Design.  One block per (beam row, region); one thread per lag, which
// walks its own diagonal ip = max(0, L-N+1) .. min(L, mmax-1) from zero
// state and keeps the whole recurrence state in registers.  The region's
// codes, positions and hash coefficients (4N int32) and the small tables
// (pair weights, pair types, stack energies) are staged in shared memory.
// Every output is written once, coalesced across the block's lags.
//
// What bounds it on this card.  The work is integer and f32 scalar code,
// about 60 operations per cell, over rows * R * sum of diagonal lengths
// (at most N^2 cells per region); output is 7 * 4 bytes * 2N per region.
// At the N=128 headline (800 rows x 16 regions) that is up to 210 M cells
// and 92 MB of stores, so the kernel is bound by issue rate and by the
// imbalance between short and long diagonals, not by memory bandwidth.
// The design keeps every cell in registers and shared memory (no state
// goes through device memory); balancing the diagonals across warps and
// scanning only the M selected lags in full is later work.
//
// Exactness.  tot = (tot_p + w) * w is one IEEE add and one IEEE multiply
// (__fadd_rn/__fmul_rn, and the library is built with --fmad=false);
// hashes are uint32 arithmetic mod 2^32; the half-window width uses floor
// division, as the JAX code does, because it is negative past 2*mlen-1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int floormod(int a, int b) {
  return a - floordiv(a, b) * b;
}

__global__ void wavefront_kernel(
    const int* __restrict__ rcodes, const int* __restrict__ rpos,
    const int* __restrict__ mlen, const int* __restrict__ z1row,
    const int* __restrict__ z2row, const float* __restrict__ Wg,
    const int* __restrict__ PTg, const int* __restrict__ STg,
    float* __restrict__ cor_out, int* __restrict__ nb_out,
    int* __restrict__ mi_out, int* __restrict__ mj_out,
    int* __restrict__ sE_out, int* __restrict__ hd1_out,
    int* __restrict__ hd2_out, int R, int N, int min_hp) {
  extern __shared__ int smem[];
  int* s_codes = smem;
  int* s_pos = smem + N;
  uint32_t* s_z1 = reinterpret_cast<uint32_t*>(smem + 2 * N);
  uint32_t* s_z2 = reinterpret_cast<uint32_t*>(smem + 3 * N);
  __shared__ float s_W[25];
  __shared__ int s_PT[25];
  __shared__ int s_ST[64];
  __shared__ int s_mmax;

  const int region = blockIdx.x;  // beam row * R + region slot
  const int row = region / R;
  const long in_base = static_cast<long>(region) * N;
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    s_codes[t] = rcodes[in_base + t];
    s_pos[t] = rpos[in_base + t];
    s_z1[t] = static_cast<uint32_t>(z1row[in_base + t]);
    s_z2[t] = static_cast<uint32_t>(z2row[in_base + t]);
  }
  if (threadIdx.x < 25) {
    s_W[threadIdx.x] = Wg[threadIdx.x];
    // zero pair type (no pair) reads as 7, as in the TPU select chains
    const int pt = PTg[threadIdx.x];
    s_PT[threadIdx.x] = pt != 0 ? pt : 7;
  }
  if (threadIdx.x < 64) s_ST[threadIdx.x] = STg[threadIdx.x];
  if (threadIdx.x == 0) {
    int mm = 0;
    for (int r = 0; r < R; ++r) mm = max(mm, mlen[row * R + r]);
    s_mmax = mm;
  }
  __syncthreads();

  const int m = mlen[region];
  const int mmax = s_mmax;
  const long out_base = static_cast<long>(region) * 2 * N;

  for (int L = threadIdx.x; L < 2 * N; L += blockDim.x) {
    float tot = 0.f, cor = 0.f, ms = 0.f;
    int tmp = 0, sE = 0, nb = 0, mi = 0, mj = 0, bsE = 0;
    uint32_t hd1 = 0u, hd2 = 0u, bh1 = 0u, bh2 = 0u;
    if (L < mmax + N - 1) {
      const int ip0 = max(0, L - N + 1);
      const int ip1 = min(L, mmax - 1);
      const int lo = max(L - m + 1, 0);
      const int w_width = L < m ? L + 1 : 2 * m - L - 1;
      const int half = floordiv(w_width, 2) + floormod(w_width, 2);
      for (int ip = ip0; ip <= ip1; ++ip) {
        const int jp = L - ip;
        const int c5 = s_codes[ip], p5 = s_pos[ip];
        const int c5m = ip > 0 ? s_codes[ip - 1] : 0;
        const int p5m = ip > 0 ? s_pos[ip - 1] : -9;
        const int c3 = s_codes[jp], p3 = s_pos[jp];
        const int c3p = jp < N - 1 ? s_codes[jp + 1] : 0;
        const int p3p = jp < N - 1 ? s_pos[jp + 1] : -9;

        const unsigned lw = static_cast<unsigned>(c5 * 5 + c3);
        const float w = lw < 25u ? s_W[lw] : 0.f;
        const bool contig = (ip > lo) && (p5 - p5m == 1) && (p3p - p3 == 1);
        const float tot_p = tot;
        tot = contig ? __fmul_rn(__fadd_rn(tot_p, w), w) : w;
        tmp = tot == 0.f ? 0 : tmp + 1;
        // stack energy between outer pair (ip-1, jp+1) and inner (ip, jp)
        const unsigned la = static_cast<unsigned>(c5m * 5 + c3p);
        const unsigned lb = static_cast<unsigned>(c3 * 5 + c5);
        const int A = la < 25u ? s_PT[la] : 7;
        const int Bt = lb < 25u ? s_PT[lb] : 7;
        const int g = (A <= 6 && Bt <= 6) ? s_ST[A * 8 + Bt] : 0;
        const bool in_run = (tot != 0.f) && (tot_p != 0.f) && contig;
        sE = (tot == 0.f || tot_p == 0.f) ? 0 : (in_run ? sE + g : sE);
        // hash delta of pairing (p5, p3): Z[p5]*(p3+1) + Z[p3]*(p5+1)
        const uint32_t a3 = static_cast<uint32_t>(p3 + 1);
        const uint32_t a5 = static_cast<uint32_t>(p5 + 1);
        hd1 = tot == 0.f ? 0u : hd1 + s_z1[ip] * a3 + s_z1[jp] * a5;
        hd2 = tot == 0.f ? 0u : hd2 + s_z2[ip] * a3 + s_z2[jp] * a5;

        const bool upd = (ip - lo < half) && ((p3 - p5) > min_hp) && (tot >= ms);
        if (upd) {
          ms = tot;
          nb = tmp;
          mi = ip;
          mj = jp;
          bsE = sE;
          bh1 = hd1;
          bh2 = hd2;
        }
        cor = __fadd_rn(cor, w);
      }
    }
    cor_out[out_base + L] = cor;
    nb_out[out_base + L] = nb;
    mi_out[out_base + L] = mi;
    mj_out[out_base + L] = mj;
    sE_out[out_base + L] = bsE;
    hd1_out[out_base + L] = static_cast<int>(bh1);
    hd2_out[out_base + L] = static_cast<int>(bh2);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers to contiguous int32 / float32 arrays: rcodes, rpos, z1row,
// z2row [rows, R, N]; mlen [rows, R]; W [25] f32; PT [25]; ST [64];
// outputs [rows, R, 2N].  Launches on `stream` and returns the
// cudaError_t of the launch (0 on success).
extern "C" int rafft_wavefront(
    const int* rcodes, const int* rpos, const int* mlen, const int* z1row,
    const int* z2row, const float* W, const int* PT, const int* ST,
    float* cor, int* nb, int* mi, int* mj, int* sE, int* hd1, int* hd2,
    int rows, int R, int N, int min_hp, void* stream) {
  if (rows <= 0 || R <= 0 || N <= 0) return 0;
  const int threads = 2 * N < 1024 ? ((2 * N + 31) / 32) * 32 : 1024;
  const size_t smem = 4 * static_cast<size_t>(N) * sizeof(int);
  wavefront_kernel<<<rows * R, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      rcodes, rpos, mlen, z1row, z2row, W, PT, ST, cor, nb, mi, mj, sE, hd1,
      hd2, R, N, min_hp);
  return static_cast<int>(cudaGetLastError());
}
