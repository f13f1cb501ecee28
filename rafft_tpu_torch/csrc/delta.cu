// Every candidate stem's exact incremental energy dE, hand-written for
// Hopper (sm_90a): the fold step's stage `delta`.
//
// Replaces no TPU kernel: fold_jax._candidate_delta (rafft_tpu/engine/
// fold_jax.py) was an XLA program, and the port ran it as about a thousand
// PyTorch operators over the [B, K, R, M] candidate lanes (the plain
// version, rafft_tpu_torch/engine/delta.py:_candidate_delta).  It was added
// because the port's own H100 profile called for it: at K=200, B=16, N=128
// (10.24 M lanes) the stage took 45.0 ms of a 71.5 ms fold step, 63% of it,
// and 6.0 of 20.6 ms at K=50.  Each intermediate there is a lane-wide
// tensor of 20-40 MB, and each of four compare-and-sum passes over the
// enclosing loop's children a [B, K, R, M, 48] tensor of bools.
//
// What bounds it on this card.  Bytes: the four window tables gathered at
// the lags (max_nb, max_i, max_j, best_sE) and rpos are read once, the
// [B, K, N] loop arrays, pt, the codes and the k-mer keys once per region
// (from L2 after the first), and delta, p0, unsupported and has written
// once: about 0.30 GB at K=200, B=16, N=128, some 0.09 ms at 3.35 TB/s
// (engine/delta.py:delta_work counts them).  A lane's arithmetic is a few
// dozen integer operations and lookups in tables of 1.8 MB (mostly the
// dense hexaloop table), which stay in L2 and the read-only cache.
//
// Design.
// * One block per region (b, k, r).  The block stages the region's member
//   positions rpos and the sequence's codes in shared memory and builds the
//   region's context once: the jump prefix cumJ over rpos (a gap between
//   two member positions) and the enclosing loop's children, ascending, the
//   first C' = min(C, N) of them, with the prefix sums of their
//   multiloop-stem and exterior terms.  One block scan computes both
//   prefixes at once: the jump count in the low 16 bits, the child count in
//   the high 16 (each below N <= 4096).
// * One thread per lane: the threads stride over the region's M lags.  The
//   plain version's compare-and-sum passes over the children (ssr, ssl)
//   become binary searches over the C' children in shared memory; nothing
//   of width C' goes to device memory, and no lane-wide intermediate does.
// * The energies stay in registers, and a lane computes only the branch
//   that the plain version's where() chains select: the hairpin, two-loop
//   or multiloop term of the loop the stem closes, and the exterior,
//   two-loop or multiloop term of the loop that encloses it.  A lane
//   without a run, or with an unsupported stem, stops after p0 and the two
//   flags.
// * The kernel reads the engine's own energy tables (DeviceParams, no copy
//   of them): their pointers, the 1-D tables' lengths and the scalars are
//   staged in shared memory, the tables read through the read-only cache.
// * The block's thread count follows from M and N (a warp multiple from 64
//   to 256); shared memory is 12 N bytes, above 48 KB (N = 4096) by opting
//   in.
//
// Exactness.  Integer arithmetic throughout, with the plain version's
// clamps, bounds tests and selection order: delta, unsupported, has and p0
// equal the plain version on every lane.

#include <climits>
#include <cstddef>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxN = 4096;        // the engine's longest bucket
constexpr int kMaxChildren = 64;  // C' <= 64: one warp, two entries a lane
constexpr int kMissing = INT_MIN;  // INT_MISS of energy/params.py

// the energy tables, in energy/eval_torch.py:TABLES's order
enum {
  kPairType, kStack, kHairpin, kBulge, kInternal, kMmh, kMmi, kMm1n, kMm23,
  kMmm, kMmext, kD5, kD3, kInt11, kInt21, kInt22, kTetra, kTri, kHexa,
  kTables
};
// the header: the 1-D tables' lengths and the scalars (engine/delta.py:
// HEADER, in its order)
enum {
  kLenHairpin, kLenBulge, kLenInternal, kLenTetra, kLenTri, kLenHexa,
  kTerminalAu, kMlClosing, kMlIntern, kNinioM, kNinioMax, kHeader
};

// the kernel's arguments: the pointers in engine/delta.py:candidate_delta's
// order, then the header
struct Args {
  const int* codes;    // [B, N]
  const int* n;        // [B]
  const int* key5;     // [B, N] k-mer keys (hairpin special loops)
  const int* key6;
  const int* key8;
  const int* pt;       // [B, K, N]
  const int* rorder;   // [B, K, R]
  const int* rpos;     // [B, K, R, N]
  const uint8_t* is_open;  // [B, K, N], then the loop analysis
  const int* enclose;
  const int* mls;
  const int* exts;
  const int* branches;
  const int* loop_e;
  const int* max_nb;   // [B, K, R, M], the window tables at the lags
  const int* max_i;
  const int* max_j;
  const int* best_sE;
  int* delta;          // [B, K, R, M] outputs
  uint8_t* unsupported;
  uint8_t* has;
  int* p0;
  const int* tab[kTables];  // the energy tables, each contiguous int32
  int hdr[kHeader];
};
constexpr int kPointers = offsetof(Args, hdr) / sizeof(void*);

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// the Turner terms of energy/eval_torch.py (_hairpin_v, _int_loop_v,
// _ml_stem, _ext_stem_v), each computing only the branch its where()
// chain selects
struct Energy {
  const int* const* t;  // the tables' pointers, in shared memory
  const int* h;         // the header, in shared memory

  __device__ int at(int table, int lin) const {
    return __ldg(t[table] + lin);
  }
  __device__ int len(int which) const { return h[which]; }
  __device__ int ptype(int a, int b) const {
    const int x = at(kPairType, a * 5 + b);
    return x == 0 ? 7 : x;
  }
  __device__ int au(int type) const { return type > 2 ? h[kTerminalAu] : 0; }
  __device__ int mm(int table, int type, int a, int b) const {
    return at(table, (type * 5 + a) * 5 + b);
  }

  __device__ int hairpin(int type, int si1, int sj1, int size, int k5,
                         int k6, int k8) const {
    const int e = at(kHairpin, clampi(size, 0, len(kLenHairpin) - 1));
    if (size == 3) {
      const int x = at(kTri, clampi(k5, 0, len(kLenTri) - 1));
      return x != kMissing ? x : e + au(type);
    }
    const int generic = e + mm(kMmh, type, si1, sj1);
    if (size == 4) {
      const int x = at(kTetra, clampi(k6, 0, len(kLenTetra) - 1));
      return x != kMissing ? x : generic;
    }
    if (size == 6) {
      const int x = at(kHexa, clampi(k8, 0, len(kLenHexa) - 1));
      return x != kMissing ? x : generic;
    }
    return generic;
  }

  // t1 = type of the closing pair, t2 = type of the inner pair seen from
  // inside; si1/sj1 = codes[i+1]/codes[j-1], sp1/sq1 = codes[q-1]/codes[r+1];
  // n1/n2 = the unpaired runs q-i-1 / j-r-1
  __device__ int int_loop(int t1, int t2, int si1, int sj1, int sp1, int sq1,
                          int n1, int n2) const {
    const int nl = max(n1, n2), ns = min(n1, n2);
    if (nl == 0) return at(kStack, t1 * 8 + t2);
    if (ns == 0) {
      const int blg = at(kBulge, clampi(nl, 0, len(kLenBulge) - 1));
      return blg + (nl == 1 ? at(kStack, t1 * 8 + t2) : au(t1) + au(t2));
    }
    const int ninio = min((nl - ns) * h[kNinioM], h[kNinioMax]);
    const int top = len(kLenInternal) - 1;
    if (ns == 1) {
      if (nl == 1) return at(kInt11, ((t1 * 8 + t2) * 5 + si1) * 5 + sj1);
      if (nl == 2) {
        return n1 == 1
            ? at(kInt21, (((t1 * 8 + t2) * 5 + si1) * 5 + sq1) * 5 + sj1)
            : at(kInt21, (((t2 * 8 + t1) * 5 + sq1) * 5 + si1) * 5 + sp1);
      }
      return at(kInternal, clampi(nl + 1, 0, top)) + ninio
          + mm(kMm1n, t1, si1, sj1) + mm(kMm1n, t2, sq1, sp1);
    }
    if (ns == 2 && nl == 2) {
      return at(kInt22,
                ((((t1 * 8 + t2) * 5 + si1) * 5 + sp1) * 5 + sq1) * 5 + sj1);
    }
    if (ns == 2 && nl == 3) {
      return at(kInternal, 5) + h[kNinioM] + mm(kMm23, t1, si1, sj1)
          + mm(kMm23, t2, sq1, sp1);
    }
    return at(kInternal, clampi(nl + ns, 0, top)) + ninio
        + mm(kMmi, t1, si1, sj1) + mm(kMmi, t2, sq1, sp1);
  }

  __device__ int ml_stem(int type, int s5, int s3) const {
    return mm(kMmm, type, s5, s3) + au(type) + h[kMlIntern];
  }

  __device__ int ext_stem(int type, int s5, int s3, bool has5,
                          bool has3) const {
    int e = 0;
    if (has5 && has3) {
      e = mm(kMmext, type, s5, s3);
    } else if (has5) {
      e = at(kD5, type * 5 + s5);
    } else if (has3) {
      e = at(kD3, type * 5 + s3);
    }
    return e + au(type);
  }
};

__global__ void __launch_bounds__(kMaxThreads) delta_kernel(
    Args in, int K, int R, int M, int N, int C) {
  extern __shared__ int smem[];
  int* s_rpos = smem;        // the region's member positions, N-padded
  int* s_pre = smem + N;     // jumps (low 16 bits) and children (high 16),
                             // inclusive prefix over the positions
  int* s_codes = smem + 2 * N;
  __shared__ const int* s_tab[kTables];
  __shared__ int s_hdr[kHeader];
  __shared__ int s_chs[kMaxChildren];          // children, ascending, N past
  __shared__ int s_pml[kMaxChildren + 1];      // their prefix sums
  __shared__ int s_pext[kMaxChildren + 1];
  __shared__ int s_warp[kMaxThreads / 32];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t g = blockIdx.x;                 // the region (b, k, r)
  const size_t bk = g / R;
  const int b = static_cast<int>(bk / K);
  const int lab = in.rorder[g];
  const int* rpos = in.rpos + g * N;
  const int* codes = in.codes + static_cast<size_t>(b) * N;
  const uint8_t* is_open = in.is_open + bk * N;
  const int* enclose = in.enclose + bk * N;

  // constant indices into the arguments keep them in the parameter space
#pragma unroll
  for (int i = 0; i < kTables; ++i) {
    if (tid == i) s_tab[i] = in.tab[i];
  }
#pragma unroll
  for (int i = 0; i < kHeader; ++i) {
    if (tid == i) s_hdr[i] = in.hdr[i];
  }
  for (int x = tid; x < N; x += nt) {
    s_rpos[x] = rpos[x];
    s_codes[x] = codes[x];
    s_pre[x] = (lab > -2 && is_open[x] && enclose[x] == lab) ? 1 << 16 : 0;
  }
  __syncthreads();

  // block scan: each thread sums a run of consecutive positions, the
  // warps scan the runs' sums
  const int per = (N + nt - 1) / nt;
  const int x0 = min(tid * per, N), x1 = min(x0 + per, N);
  int sum = 0;
  for (int x = x0; x < x1; ++x) {
    sum += s_pre[x] + (x > 0 && s_rpos[x] - s_rpos[x - 1] > 1);
    s_pre[x] = sum;
  }
  int incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int base = incl - sum;
  for (int w = 0; w < warp; ++w) base += s_warp[w];
  for (int x = x0; x < x1; ++x) s_pre[x] += base;
  __syncthreads();

  // the first C' children, ascending, N past the last of them
  const int nch = s_pre[N - 1] >> 16;
  const int Cp = min(C, N);
  for (int x = tid; x < N; x += nt) {
    const int c = s_pre[x] >> 16;
    if (c != (x > 0 ? s_pre[x - 1] >> 16 : 0) && c <= Cp) s_chs[c - 1] = x;
  }
  for (int i = nch + tid; i < Cp; i += nt) s_chs[i] = N;
  __syncthreads();

  // prefix sums of the children's multiloop-stem and exterior terms
  if (warp == 0) {
    const int* mls = in.mls + bk * N;
    const int* exts = in.exts + bk * N;
    int v0 = 0, e0 = 0, v1 = 0, e1 = 0;
    if (lane < Cp && s_chs[lane] < N) {
      v0 = mls[s_chs[lane]];
      e0 = exts[s_chs[lane]];
    }
    if (lane + 32 < Cp && s_chs[lane + 32] < N) {
      v1 = mls[s_chs[lane + 32]];
      e1 = exts[s_chs[lane + 32]];
    }
    for (int d = 1; d < 32; d <<= 1) {
      const int a0 = __shfl_up_sync(0xffffffffu, v0, d);
      const int b0 = __shfl_up_sync(0xffffffffu, e0, d);
      const int a1 = __shfl_up_sync(0xffffffffu, v1, d);
      const int b1 = __shfl_up_sync(0xffffffffu, e1, d);
      if (lane >= d) {
        v0 += a0;
        e0 += b0;
        v1 += a1;
        e1 += b1;
      }
    }
    const int tv = __shfl_sync(0xffffffffu, v0, 31);
    const int te = __shfl_sync(0xffffffffu, e0, 31);
    if (lane < Cp) {
      s_pml[lane + 1] = v0;
      s_pext[lane + 1] = e0;
    }
    if (lane + 32 < Cp) {
      s_pml[lane + 33] = v1 + tv;
      s_pext[lane + 33] = e1 + te;
    }
    if (lane == 0) s_pml[0] = s_pext[0] = 0;
  }
  __syncthreads();

  const Energy E{s_tab, s_hdr};
  const int nb = in.n[b];
  const int* pt = in.pt + bk * N;
  const int* key5 = in.key5 + static_cast<size_t>(b) * N;
  const int* key6 = in.key6 + static_cast<size_t>(b) * N;
  const int* key8 = in.key8 + static_cast<size_t>(b) * N;
  const int ml_closing = s_hdr[kMlClosing];

  auto cN = [N](int x) { return clampi(x, 0, N - 1); };
  auto valid = [nb](int j) { return j >= 0 && j < nb; };
  auto cm1 = [&](int c) { return c > 0 ? s_codes[c - 1] : 0; };
  auto cp1 = [&](int c) { return c < N - 1 ? s_codes[c + 1] : 0; };
  // the plain version's m_clip: codes around clip(x), bounds on clip(x)+off
  auto at_c = [&](int x) { const int c = cN(x); return valid(c) ? s_codes[c] : 0; };
  auto prev_c = [&](int x) { const int c = cN(x); return valid(c - 1) ? cm1(c) : 0; };
  auto next_c = [&](int x) { const int c = cN(x); return valid(c + 1) ? cp1(c) : 0; };
  // its m_raw: the same values, bounds on the raw x+off
  auto at_r = [&](int x) { return valid(x) ? s_codes[cN(x)] : 0; };
  auto prev_r = [&](int x) { return valid(x - 1) ? cm1(cN(x)) : 0; };
  auto next_r = [&](int x) { return valid(x + 1) ? cp1(cN(x)) : 0; };
  // ssr(q): the first child with start > q; ssl(q): with start >= q
  auto ssr = [&](int q) {
    int lo = 0, hi = Cp;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_chs[mid] <= q) lo = mid + 1; else hi = mid;
    }
    return lo;
  };
  auto ssl = [&](int q) {
    int lo = 0, hi = Cp;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_chs[mid] < q) lo = mid + 1; else hi = mid;
    }
    return lo;
  };
  auto prange = [&](const int* pref, int lo, int hi) {
    return pref[clampi(hi, 0, Cp)] - pref[clampi(lo, 0, Cp)];
  };
  // closing pair (x, y) seen from inside; stem (x, y) seen from outside
  auto ml_close = [&](int x, int y) {
    return E.ml_stem(E.ptype(at_r(y), at_r(x)), prev_r(y), next_r(x));
  };
  auto ml_stem = [&](int x, int y) {
    return E.ml_stem(E.ptype(at_r(x), at_r(y)), prev_r(x), next_r(y));
  };

  for (int m = tid; m < M; m += nt) {
    const size_t L = g * M + m;
    const int run = in.max_nb[L], is = in.max_i[L], js = in.max_j[L];
    const bool has = run > 0;
    const int ip = cN(is), iq = cN(js);
    const int ia = cN(is - run + 1), ib = cN(js + run - 1);
    const int p0 = s_rpos[ip];
    const int ngaps = has ? ((s_pre[ip] & 0xffff) - (s_pre[ia] & 0xffff))
                          + ((s_pre[ib] & 0xffff) - (s_pre[iq] & 0xffff))
                          : 0;
    const bool unsup = has && (ngaps > 0 || nch > C);
    in.p0[L] = p0;
    in.has[L] = has;
    in.unsupported[L] = unsup;
    if (!has || unsup) {
      in.delta[L] = 0;
      continue;
    }
    const int q0 = s_rpos[iq], a = s_rpos[ia], b2 = s_rpos[ib];

    // the loop the stem closes: (p0, q0) and the children between
    const int lo_in = ssr(p0), hi_in = ssl(q0), cin = hi_in - lo_in;
    const int t_pq = E.ptype(at_c(p0), at_c(q0));
    int inner;
    if (cin == 0) {
      const int c = cN(p0);
      inner = E.hairpin(t_pq, next_c(p0), prev_c(q0), cN(q0) - c - 1,
                        key5[c], key6[c], key8[c]);
    } else if (cin == 1) {
      const int fc = s_chs[clampi(lo_in, 0, Cp - 1)];
      const int fe = pt[cN(fc)];
      inner = E.int_loop(t_pq, E.ptype(at_c(fe), at_c(fc)), next_c(p0),
                         prev_c(q0), prev_c(fc), next_c(fe),
                         cN(fc) - cN(p0) - 1, cN(q0) - cN(fe) - 1);
    } else {
      inner = ml_closing + ml_close(p0, q0) + prange(s_pml, lo_in, hi_in);
    }

    // the loop that encloses it: the children from a to b2 leave it
    const int lo_sw = ssr(a - 1), hi_sw = ssl(b2 + 1);
    int dL;
    if (lab == -1) {
      const int ext = E.ext_stem(E.ptype(at_c(a), at_c(b2)), prev_c(a),
                                 next_c(b2), cN(a) > 0, cN(b2) < nb - 1);
      dL = ext - prange(s_pext, lo_sw, hi_sw);
    } else {
      const int labc = cN(lab);
      const int jl = pt[labc];
      const int eL = in.loop_e[bk * N + labc];
      if (in.branches[bk * N + labc] - (hi_sw - lo_sw) + 1 == 1) {
        dL = E.int_loop(E.ptype(at_c(lab), at_c(jl)),
                        E.ptype(at_c(b2), at_c(a)), next_c(lab), prev_c(jl),
                        prev_c(a), next_c(b2), cN(a) - labc - 1,
                        cN(jl) - cN(b2) - 1) - eL;
      } else {
        dL = ml_closing + ml_close(lab, jl) + s_pml[clampi(nch, 0, Cp)]
            - prange(s_pml, lo_sw, hi_sw) + ml_stem(a, b2) - eL;
      }
    }
    in.delta[L] = in.best_sE[L] + inner + dL;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  ptrs holds the kPointers device
// pointers of Args, in its order, each a contiguous array of the shape
// noted there (is_open, unsupported and has one byte an entry, the rest
// int32), and header (host memory) the kHeader ints of its header;
// regions = B * K * R.  Launches on `stream` and returns the cudaError_t
// of the launch (0 on success).
extern "C" int rafft_delta(void* const* ptrs, int nptrs, const int* header,
                           int nheader, int regions, int K, int R, int M,
                           int N, int C, void* stream) {
  if (nptrs != kPointers || nheader != kHeader) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (regions <= 0 || M <= 0) return 0;
  if (K <= 0 || R <= 0 || N <= 0 || N > kMaxN || C < 1
      || C > kMaxChildren) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args in;
  void** dst = reinterpret_cast<void**>(&in);
  for (int i = 0; i < kPointers; ++i) dst[i] = ptrs[i];
  for (int i = 0; i < kHeader; ++i) in.hdr[i] = header[i];
  // a thread per lag, and enough threads for the staging of long regions
  int threads = ((max(M, N / 8) + 31) / 32) * 32;
  threads = min(max(threads, 64), kMaxThreads);
  const size_t smem = 3 * static_cast<size_t>(N) * sizeof(int);
  if (smem > 40 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        delta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  delta_kernel<<<regions, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, K, R, M, N, C);
  return static_cast<int>(cudaGetLastError());
}
