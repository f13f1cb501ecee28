// The windowed combination enumeration of a fold step, hand-written for
// Hopper (sm_90a): the fold step's stage `enumerate`.
//
// Replaces no TPU kernel: the enumeration of fold_jax._seq_step (rafft_tpu/
// engine/fold_jax.py :1076-1359) was an XLA while loop, and the port ran it
// as a Python loop over all W windows of plain PyTorch operators (the plain
// version, rafft_tpu_torch/engine/enumerate.py:_enumerate_combos).  It was
// added because the port's own H100 profile called for it: the stage took
// 9.2 of a 14.1 ms fold step at K=50, B=16, N=128 and 24.0 of 35.8 ms at
// N=512 (W=24 windows), about 340 kernel launches a window, each window
// run by every lane whether the lane still had combinations to visit or
// not, and each one sorting the lane's whole seen set (B x S int64) twice.
//
// What bounds it on this card.  Not bytes: a window reads at most V slots'
// R candidate entries (dE, live regions, two hash deltas), the rows'
// energies and hashes, and probes the sorted seen set, some 0.5-2 MB a lane
// and step from L2.  It is latency: a lane's windows run in order, each
// window's cap depends on the previous one's count of new combinations,
// and each window holds two sorts and a handful of block-wide scans.  So
// the work of one lane is one block, kept on chip, with as few global
// round trips as the data allows.
//
// Design.
// * One block per lane (b).  The block runs the lane's windows in order in
//   a loop and leaves it as soon as the lane is capped or exhausted: a
//   done lane, and every window the plain version runs for a finished
//   lane, cost nothing.  Every per-lane state of the loop (mode, base,
//   the count of new combinations, the cap's row, the running top-K, the
//   step's inserts) stays in shared memory.
// * The seen set is sorted once a step, before the launch (the wrapper's
//   one torch.sort into scratch); the block keeps every 32nd key of it in
//   shared memory and tests a key by a binary search there and then in one
//   32-key segment.  The step's own inserts, which later windows must also
//   see, are kept sorted in a second list in global scratch (two buffers,
//   merged by rank each window); the seen set itself is copied and
//   appended to in insertion order, as the plain version does.
// * A window decodes its valid slots (g < total) only, one thread per slot:
//   the slot's row by a binary search over the rows' combination counts,
//   its candidate in each region from the mixed-radix digits, and its dE,
//   live regions and composed hashes.  One bitonic sort of the window's
//   (key, slot) pairs in shared memory serves both dedup passes: pass 1's
//   first occurrence is a run start, pass 2's is read from a scan of the
//   processed flags over the same order.  The window's top-K is a second
//   sort, of the new slots' packed (E, g) keys only, merged by rank with
//   the running top-K; since every key is distinct, that merge is the
//   plain version's stable lexsort.
// * The running beam holds only the step's new combinations, as packed
//   (E, g) keys; its rows (row, candidates, E, hashes) are decoded from g
//   once, at the end.  Its other rows are the ones it started with (valid
//   false, E INFE, the rest 0): a non-new row of the plain version's window
//   top-K never displaces them, its key (INFE, g >= 0) sorting after
//   theirs.
// * Shared memory follows V, K, R and S (enumerate_layout): at V=4096,
//   K=255, R=32, S=32,640 about 160 KB, above 48 KB by opting in.  Threads:
//   one per pair of the largest sort, 128 to 1024.
//
// Exactness.  Integer arithmetic with the plain version's clamps (row
// products and strides at 2^20), hashes mod 2^32 and int64 energies;
// every output equals the plain version's on every lane, the beam's
// unused rows included.

#include <climits>
#include <cstddef>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMinThreads = 128;
constexpr int kMaxV = 4096;        // slots a window: 16-bit slot indices
constexpr int kMaxK = 255;         // a slot's row in 8 bits
constexpr int kMaxR = 64;          // a slot's live regions in 8 bits
constexpr int kMaxS = 65535;
constexpr int kSplit = 32;         // sorted seen keys per splitter
constexpr long long kClamp = 1 << 20;
constexpr long long kInfE = 1 << 30;
constexpr int64_t kBig = LLONG_MAX;
constexpr size_t kSmemLimit = 232448;   // 227 KB a block
enum { kNorm = 0, kFirst = 1, kDone = 2 };
// a slot's flags
constexpr uint8_t kSeen = 1;   // its key is in the seen set
constexpr uint8_t kNew1 = 2;   // new in pass 1 (first valid of its key)
constexpr uint8_t kNew2 = 4;   // new in pass 2 (first processed of its key)
constexpr uint8_t kOk = 8;     // a post-cap first combo to consider

// the kernel's arguments: the pointers in engine/enumerate.py:
// enumerate_combos's order
struct Args {
  const int* Dd;           // [B, K, R, M] in each region's order
  const int* Dn;
  const int64_t* Dh1;
  const int64_t* Dh2;
  const int* s_r;          // [B, K, R] accepted candidates a region
  const int* energy;       // [B, K]
  const int64_t* ph1;      // [B, K] the rows' hashes
  const int64_t* ph2;
  const uint8_t* done;     // [B]
  const int64_t* seen_h1;  // [B, S]
  const int64_t* seen_h2;
  const int* seen_cnt;     // [B]
  const int64_t* ordered;  // [B, S] the seen keys, first seen_cnt sorted
  int64_t* inserts;        // [B, 2, S] scratch: the step's inserts, sorted
  int64_t* out_h1;         // [B, S]
  int64_t* out_h2;
  int64_t* out_cnt;        // [B]
  int64_t* mode;
  int64_t* rneed;
  uint8_t* suss;
  int* windows;
  uint8_t* bm_valid;       // [B, K]
  int64_t* bm_E;
  int64_t* bm_tie;
  int64_t* bm_kv;
  int64_t* bm_idx;         // [B, K, R]
  uint8_t* bm_on;          // [B, K, R]
  int64_t* bm_h1;          // [B, K]
  int64_t* bm_h2;
};
constexpr int kPointers = sizeof(Args) / sizeof(void*);

struct Dims {
  int K, R, M, V, W, S;
  long long max_branch;
};

__host__ __device__ inline int pow2ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ inline size_t carve(size_t& at, size_t bytes) {
  const size_t here = at;
  at += (bytes + 15) & ~static_cast<size_t>(15);
  return here;
}

// byte offsets of the shared arrays (wide types first)
struct Layout {
  size_t skey, pk, sp, bm, local, Pk, fs, en, ph1, ph2, sr, sv, scanA,
      scanB, kv, nl, flags, wsum, total;
};

__host__ __device__ inline Layout enumerate_layout(int V, int K, int R,
                                                   int S) {
  const size_t Vp = pow2ceil(V), nsp = (S + kSplit - 1) / kSplit;
  Layout L;
  size_t at = 0;
  L.skey = carve(at, 8 * Vp);    // window keys / packed (E, g) keys
  L.pk = carve(at, 8 * Vp);      // per slot: packed (E, g)
  L.sp = carve(at, 8 * nsp);     // every kSplit-th sorted seen key
  L.bm = carve(at, 8 * 2 * K);   // the running top-K, two buffers
  L.local = carve(at, 4 * Vp);   // per slot: index within its row
  L.Pk = carve(at, 4 * K);       // rows' inclusive combination counts
  L.fs = carve(at, 4 * K);       // rows' first combination
  L.en = carve(at, 4 * K);
  L.ph1 = carve(at, 4 * K);
  L.ph2 = carve(at, 4 * K);
  L.sr = carve(at, 2 * K * R);   // accepted candidates a region
  L.sv = carve(at, 2 * Vp);      // the sort's slot indices
  L.scanA = carve(at, 2 * (Vp + 1));
  L.scanB = carve(at, 2 * (Vp + 1));
  L.kv = carve(at, Vp);          // per slot: its row
  L.nl = carve(at, Vp);          // per slot: live regions
  L.flags = carve(at, Vp);
  L.wsum = carve(at, 4 * 33);
  L.total = at;
  return L;
}

// the lane's loop state, thread 0 writes, all read after a barrier
struct Lane {
  long long s_cnt, nbr, kcap, base, kcap_w;
  int mode, rneed, suss, nins, cur, nbm, bmcur, windows, cap_v;
};

struct Shared {
  int64_t* skey;
  int64_t* pk;
  int64_t* sp;
  int64_t* bm;
  int* local;
  int* Pk;
  int* fs;
  int* en;
  uint32_t* ph1;
  uint32_t* ph2;
  uint16_t* sr;
  uint16_t* sv;
  uint16_t* scanA;
  uint16_t* scanB;
  uint8_t* kv;
  uint8_t* nl;
  uint8_t* flags;
  int* wsum;
};

__device__ inline int64_t hkey(uint32_t h1, uint32_t h2) {
  // fold_torch._hkey: (h1 - 2^31) * 2^32 + h2
  return static_cast<int64_t>(((static_cast<uint64_t>(h1) << 32) | h2)
                              ^ 0x8000000000000000ULL);
}

__device__ inline int64_t pack(int64_t E, int64_t g) {
  // _lexsort2's key E * 2^32 + g, wrapping as int64 does
  return static_cast<int64_t>((static_cast<uint64_t>(E) << 32)
                              + static_cast<uint64_t>(g));
}

// first index in a[0, n) whose value is >= x (a ascending)
template <class T>
__device__ inline int lower_bound(const T* a, int n, int64_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first index in a[0, n) whose value is > x (a ascending)
__device__ inline int upper_bound(const int* a, int n, int64_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Exclusive prefix sums of pred(i) in {0, 1} over i in [0, n) into
// out[0..n] (out[n] the total); returns the total to every thread.
template <class Pred>
__device__ int block_scan(int n, Pred pred, uint16_t* out, int* wsum) {
  __syncthreads();
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, nw = T >> 5;
  const int per = (n + T - 1) / T;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += pred(i) ? 1 : 0;
  int x = s;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? wsum[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nw) wsum[lane] = w;
  }
  __syncthreads();
  int at = x - s + (warp > 0 ? wsum[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    out[i] = static_cast<uint16_t>(at);
    at += pred(i) ? 1 : 0;
  }
  const int total = wsum[nw - 1];
  if (tid == 0) out[n] = static_cast<uint16_t>(total);
  __syncthreads();
  return total;
}

// ascending bitonic sort of key[0, n), n a power of two (or 0), by (key,
// val) where val is given
template <bool kWithVal>
__device__ void bitonic(int64_t* key, uint16_t* val, int n) {
  __syncthreads();
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int lj = __ffs(j) - 1;
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int i = ((t >> lj) << (lj + 1)) | (t & (j - 1));
        const int l = i | j;
        const int64_t a = key[i], c = key[l];
        bool gt = a > c;
        if (kWithVal) gt = gt || (a == c && val[i] > val[l]);
        if (gt == ((i & k) == 0)) {
          key[i] = c;
          key[l] = a;
          if (kWithVal) {
            const uint16_t x = val[i];
            val[i] = val[l];
            val[l] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// one combination of the lane: its row and index within the row, its
// energy, live regions and hashes; region(r, idx, part) sees each region's
// candidate index
struct Combo {
  int kv;
  long long local;
  long long E;
  int nl;
  uint32_t h1, h2;
};

__device__ inline long long ld64(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}

// the lane's candidate arrays and staged rows, to decode a combination
struct Ctx {
  const int* Dd;
  const int* Dn;
  const int64_t* Dh1;
  const int64_t* Dh2;
  const int* Pk;
  const int* en;
  const uint32_t* ph1;
  const uint32_t* ph2;
  const uint16_t* sr;
  int b, K, R, M;

  template <class F>
  __device__ Combo decode(long long g, F&& region) const {
    Combo c;
    c.kv = upper_bound(Pk, K, g);
    const int kvc = min(c.kv, K - 1);
    c.local = g - (c.kv > 0 ? Pk[c.kv - 1] : 0);
    c.E = en[kvc];
    c.nl = 0;
    c.h1 = ph1[kvc];
    c.h2 = ph2[kvc];
    const uint16_t* szr = sr + kvc * R;
    const size_t row = (static_cast<size_t>(b) * K + kvc) * R;
    long long stride = 1;
    for (int r = R - 1; r >= 0; --r) {
      const int s = szr[r];
      const long long sz = s > 0 ? s : 1;
      const int idx = static_cast<int>((c.local / stride) % sz);
      if (s > 0) {
        const size_t lin = (row + r) * M + idx;
        c.E += __ldg(Dd + lin);
        c.nl += __ldg(Dn + lin);
        c.h1 += static_cast<uint32_t>(ld64(Dh1 + lin));
        c.h2 += static_cast<uint32_t>(ld64(Dh2 + lin));
      }
      region(r, idx, s > 0);
      stride = min(stride * sz, kClamp);
    }
    return c;
  }
};

struct NoRegion {
  __device__ void operator()(int, int, bool) const {}
};

// whether key x is in the seen set: the sorted first cnt0 keys (ord, with
// every kSplit-th in sp[0, nsp)) or the step's sorted inserts ins[0, nins)
__device__ inline bool member(int64_t x, const int64_t* ord, int cnt0,
                              const int64_t* sp, int nsp, const int64_t* ins,
                              int nins) {
  int lo = 0, hi = nsp;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sp[mid] <= x) lo = mid + 1; else hi = mid;
  }
  if (lo > 0) {
    const int a0 = (lo - 1) * kSplit, a1 = min(cnt0, a0 + kSplit);
    const int at = a0 + lower_bound(ord + a0, a1 - a0, x);
    if (at < a1 && ld64(ord + at) == x) return true;
  }
  const int at = lower_bound(ins, nins, x);
  return at < nins && ins[at] == x;
}

__global__ void __launch_bounds__(kMaxThreads)
enumerate_kernel(Args a, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Lane st;
  const int K = d.K, R = d.R, V = d.V, S = d.S;
  const Layout L = enumerate_layout(V, K, R, S);
  Shared sh;
  sh.skey = reinterpret_cast<int64_t*>(smem + L.skey);
  sh.pk = reinterpret_cast<int64_t*>(smem + L.pk);
  sh.sp = reinterpret_cast<int64_t*>(smem + L.sp);
  sh.bm = reinterpret_cast<int64_t*>(smem + L.bm);
  sh.local = reinterpret_cast<int*>(smem + L.local);
  sh.Pk = reinterpret_cast<int*>(smem + L.Pk);
  sh.fs = reinterpret_cast<int*>(smem + L.fs);
  sh.en = reinterpret_cast<int*>(smem + L.en);
  sh.ph1 = reinterpret_cast<uint32_t*>(smem + L.ph1);
  sh.ph2 = reinterpret_cast<uint32_t*>(smem + L.ph2);
  sh.sr = reinterpret_cast<uint16_t*>(smem + L.sr);
  sh.sv = reinterpret_cast<uint16_t*>(smem + L.sv);
  sh.scanA = reinterpret_cast<uint16_t*>(smem + L.scanA);
  sh.scanB = reinterpret_cast<uint16_t*>(smem + L.scanB);
  sh.kv = smem + L.kv;
  sh.nl = smem + L.nl;
  sh.flags = smem + L.flags;
  sh.wsum = reinterpret_cast<int*>(smem + L.wsum);
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const Ctx ctx{a.Dd, a.Dn, a.Dh1, a.Dh2, sh.Pk, sh.en, sh.ph1, sh.ph2,
                sh.sr, b, K, R, d.M};

  // ---- the lane: copy its seen set, stage its rows
  const size_t sb = static_cast<size_t>(b) * S;
  int64_t* out1 = a.out_h1 + sb;
  int64_t* out2 = a.out_h2 + sb;
  for (int s = tid; s < S; s += T) {
    out1[s] = ld64(a.seen_h1 + sb + s);
    out2[s] = ld64(a.seen_h2 + sb + s);
  }
  for (int i = tid; i < K * R; i += T) {
    sh.sr[i] = static_cast<uint16_t>(__ldg(a.s_r + static_cast<size_t>(b) * K
                                           * R + i));
  }
  for (int k = tid; k < K; k += T) {
    sh.en[k] = __ldg(a.energy + b * K + k);
    sh.ph1[k] = static_cast<uint32_t>(ld64(a.ph1 + b * K + k));
    sh.ph2[k] = static_cast<uint32_t>(ld64(a.ph2 + b * K + k));
  }
  const int cnt0 = __ldg(a.seen_cnt + b);
  const bool done = __ldg(a.done + b) != 0;
  __syncthreads();
  // each row's combination count: the product of its regions' sizes,
  // saturating at kClamp, 0 for a row with no region to combine
  for (int k = tid; k < K; k += T) {
    long long p = 1;
    bool any = false;
    for (int r = 0; r < R; ++r) {
      const int s = sh.sr[k * R + r];
      any |= s > 0;
      p = min(p * (s > 0 ? s : 1), kClamp);
    }
    sh.fs[k] = any ? static_cast<int>(p) : 0;
  }
  __syncthreads();
  if (tid < 32) {   // Pk = inclusive prefix of the counts, fs = exclusive
    const int c = (K + 31) / 32, lo = min(K, tid * c), hi = min(K, lo + c);
    int s = 0;
    for (int k = lo; k < hi; ++k) s += sh.fs[k];
    int x = s;
    for (int dd = 1; dd < 32; dd <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, dd);
      if (tid >= dd) x += y;
    }
    int run = x - s;
    for (int k = lo; k < hi; ++k) {
      const int p = sh.fs[k];
      sh.fs[k] = run;
      run += p;
      sh.Pk[k] = run;
    }
  }
  const int64_t* ord = a.ordered + sb;
  const int nsp = (cnt0 + kSplit - 1) / kSplit;
  for (int j = tid; j < nsp; j += T) sh.sp[j] = ld64(ord + j * kSplit);
  if (tid == 0) {
    st.s_cnt = cnt0;
    st.nbr = 0;
    st.kcap = K;
    st.base = 0;
    st.mode = kNorm;
    st.rneed = 0;
    st.suss = 0;
    st.nins = 0;
    st.cur = 0;
    st.nbm = 0;
    st.bmcur = 0;
    st.windows = 0;
  }
  __syncthreads();
  const long long total = sh.Pk[K - 1];
  int64_t* ins = a.inserts + static_cast<size_t>(b) * 2 * S;

  // ---- merge the sorted keys key[0, m) into the running top-K
  auto merge_top = [&](const int64_t* key, int m) {
    const int64_t* cur = sh.bm + st.bmcur * K;
    int64_t* nxt = sh.bm + (st.bmcur ^ 1) * K;
    const int nbm = st.nbm;
    for (int i = tid; i < m; i += T) {
      const int at = i + lower_bound(cur, nbm, key[i]);
      if (at < K) nxt[at] = key[i];
    }
    for (int j = tid; j < nbm; j += T) {
      const int at = j + lower_bound(key, m, cur[j]);
      if (at < K) nxt[at] = cur[j];
    }
    __syncthreads();
    if (tid == 0) {
      st.nbm = min(K, nbm + m);
      st.bmcur ^= 1;
    }
  };

  // ---- the windows, in order, while the lane runs
  for (int w = 0; w < d.W && !done; ++w) {
    if (st.mode != kNorm) break;
    const long long base = st.base;
    const int nvalid = static_cast<int>(
        max(0LL, min(static_cast<long long>(V), total - base)));
    const int Vs = nvalid ? pow2ceil(nvalid) : 0;
    const int nins = st.nins;
    const int64_t* old = ins + st.cur * S;
    // decode the valid slots
    for (int v = tid; v < Vs; v += T) {
      if (v < nvalid) {
        const Combo c = ctx.decode(base + v, NoRegion());
        sh.skey[v] = hkey(c.h1, c.h2);
        sh.pk[v] = pack(c.E, base + v);
        sh.kv[v] = static_cast<uint8_t>(c.kv);
        sh.local[v] = static_cast<int>(c.local);
        sh.nl[v] = static_cast<uint8_t>(c.nl);
      } else {
        sh.skey[v] = kBig;
      }
      sh.sv[v] = static_cast<uint16_t>(v);
    }
    bitonic<true>(sh.skey, sh.sv, Vs);
    // pass 1 in key order: a valid slot is first at its key's run start
    for (int i = tid; i < Vs; i += T) {
      const int v = sh.sv[i];
      if (v < nvalid) {
        const int64_t x = sh.skey[i];
        const bool first = i == 0 || sh.skey[i - 1] != x;
        const bool seen = member(x, ord, cnt0, sh.sp, nsp, old, nins);
        sh.flags[v] = (seen ? kSeen : 0) | (first && !seen ? kNew1 : 0);
      }
    }
    const int t1 = block_scan(
        nvalid, [&](int v) { return (sh.flags[v] & kNew1) != 0; }, sh.scanA,
        sh.wsum);
    const bool capped = st.nbr + t1 >= d.max_branch;
    uint8_t isnew = kNew1;
    int n_new = t1;
    if (capped) {
      // the cap's slot: the new one that brings the count to max_branch
      if (tid == 0) st.cap_v = 0;
      __syncthreads();
      const long long nbr = st.nbr;
      for (int v = tid; v < nvalid; v += T) {
        if ((sh.flags[v] & kNew1) && nbr + sh.scanA[v] + 1 == d.max_branch) {
          st.cap_v = v;
        }
      }
      __syncthreads();
      const int cap_v = st.cap_v;
      const long long kcap_w = upper_bound(sh.Pk, K, base + cap_v);
      // pass 2: the processed set, the prefix to the cap and the later
      // rows' first combos, deduplicated over the same key order
      auto processed = [&](int v) {
        return v < nvalid && (v <= cap_v
                              || (sh.kv[v] > kcap_w && sh.local[v] == 0));
      };
      block_scan(Vs, [&](int i) { return processed(sh.sv[i]); }, sh.scanB,
                 sh.wsum);
      for (int i = tid; i < Vs; i += T) {
        const int v = sh.sv[i];
        if (processed(v)) {
          const int rs = lower_bound(sh.skey, Vs, sh.skey[i]);
          if (sh.scanB[i] == sh.scanB[rs] && !(sh.flags[v] & kSeen)) {
            sh.flags[v] |= kNew2;
          }
        }
      }
      isnew = kNew2;
      n_new = block_scan(
          nvalid, [&](int v) { return (sh.flags[v] & kNew2) != 0; },
          sh.scanA, sh.wsum);
      if (tid == 0) st.kcap_w = kcap_w;
    } else if (tid == 0) {
      st.kcap_w = st.kcap;
    }
    // insert the new slots into the seen set (slot order); those below
    // S - 1 are seen by later windows, from the sorted inserts
    const long long s_cnt = st.s_cnt;
    for (int i = tid; i < Vs; i += T) {
      const int v = sh.sv[i];
      if (v < nvalid && (sh.flags[v] & isnew)) {
        const long long slot = s_cnt + sh.scanA[v];
        if (slot < S) {
          const uint64_t u = static_cast<uint64_t>(sh.skey[i])
              ^ 0x8000000000000000ULL;
          out1[slot] = static_cast<int64_t>(u >> 32);
          out2[slot] = static_cast<int64_t>(u & 0xffffffffULL);
        }
        atomicMax(&st.rneed, static_cast<int>(sh.nl[v]));
      }
    }
    auto inserted = [&](int i) {
      const int v = sh.sv[i];
      return v < nvalid && (sh.flags[v] & isnew)
          && s_cnt + sh.scanA[v] < S - 1;
    };
    const int nw = block_scan(Vs, inserted, sh.scanB, sh.wsum);
    if (nw > 0) {
      int64_t* nxt = ins + (st.cur ^ 1) * S;
      for (int i = tid; i < Vs; i += T) {
        if (inserted(i)) {
          nxt[sh.scanB[i] + lower_bound(old, nins, sh.skey[i])] = sh.skey[i];
        }
      }
      for (int j = tid; j < nins; j += T) {
        const int64_t x = old[j];
        nxt[j + sh.scanB[lower_bound(sh.skey, Vs, x)]] = x;
      }
    }
    // the window's top-K of new combinations by (E, g), into the beam
    __syncthreads();
    const int P2 = n_new ? pow2ceil(n_new) : 0;
    for (int v = tid; v < nvalid; v += T) {
      if (sh.flags[v] & isnew) sh.skey[sh.scanA[v]] = sh.pk[v];
    }
    for (int i = n_new + tid; i < P2; i += T) sh.skey[i] = kBig;
    bitonic<false>(sh.skey, nullptr, P2);
    if (n_new > 0) merge_top(sh.skey, min(K, n_new));
    // the lane's next mode
    const long long kcap_w = st.kcap_w;
    bool need_first = false;
    for (int k = tid; k < K; k += T) {
      need_first |= sh.Pk[k] > sh.fs[k] && k > kcap_w
          && sh.fs[k] >= base + V;
    }
    need_first = __syncthreads_or(need_first);
    if (tid == 0) {
      const int mode_w = capped ? (need_first ? kFirst : kDone)
                                : (base + V >= total ? kDone : kNorm);
      const long long s_new = s_cnt + n_new;
      st.suss |= s_new > S - 1;
      st.s_cnt = min(s_new, static_cast<long long>(S - 1));
      st.nbr += n_new;
      st.kcap = kcap_w;
      if (mode_w == kNorm) st.base = base + V;
      st.mode = mode_w;
      st.windows += 1;
      if (nw > 0) {
        st.cur ^= 1;
        st.nins = nins + nw;
      }
    }
    __syncthreads();
  }

  // ---- the post-cap first combos beyond the last window
  if (!done && st.mode == kFirst) {
    const long long base = st.base, kcap = st.kcap;
    for (int k = tid; k < K; k += T) {
      const bool ok = sh.Pk[k] > sh.fs[k] && k > kcap
          && sh.fs[k] >= base + V;
      sh.flags[k] = ok ? kOk : 0;
      if (ok) {
        const Combo c = ctx.decode(sh.fs[k], NoRegion());
        sh.skey[k] = hkey(c.h1, c.h2);
        sh.pk[k] = pack(c.E, sh.fs[k]);
        sh.nl[k] = static_cast<uint8_t>(c.nl);
      }
    }
    __syncthreads();
    const int nins = st.nins;
    const int64_t* cur = ins + st.cur * S;
    for (int k = tid; k < K; k += T) {
      if (!(sh.flags[k] & kOk)) continue;
      const int64_t x = sh.skey[k];
      bool first = true;
      for (int j = 0; j < k && first; ++j) {
        first = !((sh.flags[j] & kOk) && sh.skey[j] == x);
      }
      if (first && !member(x, ord, cnt0, sh.sp, nsp, cur, nins)) {
        sh.flags[k] |= kNew2;
      }
    }
    const int n_new = block_scan(
        K, [&](int k) { return (sh.flags[k] & kNew2) != 0; }, sh.scanA,
        sh.wsum);
    const long long s_cnt = st.s_cnt;
    for (int k = tid; k < K; k += T) {
      if (sh.flags[k] & kNew2) {
        const long long slot = s_cnt + sh.scanA[k];
        if (slot < S) {
          const uint64_t u = static_cast<uint64_t>(sh.skey[k])
              ^ 0x8000000000000000ULL;
          out1[slot] = static_cast<int64_t>(u >> 32);
          out2[slot] = static_cast<int64_t>(u & 0xffffffffULL);
        }
        atomicMax(&st.rneed, static_cast<int>(sh.nl[k]));
      }
    }
    __syncthreads();
    const int P2 = n_new ? pow2ceil(n_new) : 0;
    for (int k = tid; k < K; k += T) {
      if (sh.flags[k] & kNew2) sh.skey[sh.scanA[k]] = sh.pk[k];
    }
    for (int i = n_new + tid; i < P2; i += T) sh.skey[i] = kBig;
    bitonic<false>(sh.skey, nullptr, P2);
    if (n_new > 0) merge_top(sh.skey, n_new);
    if (tid == 0) st.s_cnt = s_cnt + n_new;
  }
  __syncthreads();

  // ---- the outputs
  if (tid == 0) {
    const long long s_cnt = st.s_cnt;
    a.out_cnt[b] = min(s_cnt, static_cast<long long>(S - 1));
    a.mode[b] = st.mode;
    a.rneed[b] = st.rneed;
    a.suss[b] = (st.suss || s_cnt > S - 1) ? 1 : 0;
    a.windows[b] = st.windows;
  }
  const int64_t* top = sh.bm + st.bmcur * K;
  const int nbm = st.nbm;
  for (int i = tid; i < K; i += T) {
    const size_t o = static_cast<size_t>(b) * K + i;
    int64_t* idx = a.bm_idx + o * R;
    uint8_t* on = a.bm_on + o * R;
    if (i < nbm) {
      const long long g = static_cast<long long>(
          static_cast<uint64_t>(top[i]) & 0xffffffffULL);
      const Combo c = ctx.decode(g, [&](int r, int x, bool part) {
        idx[r] = x;
        on[r] = part ? 1 : 0;
      });
      a.bm_valid[o] = 1;
      a.bm_E[o] = c.E;
      a.bm_tie[o] = g;
      a.bm_kv[o] = c.kv;
      a.bm_h1[o] = c.h1;
      a.bm_h2[o] = c.h2;
    } else {
      for (int r = 0; r < R; ++r) {
        idx[r] = 0;
        on[r] = 0;
      }
      a.bm_valid[o] = 0;
      a.bm_E[o] = kInfE;
      a.bm_tie[o] = 0;
      a.bm_kv[o] = 0;
      a.bm_h1[o] = 0;
      a.bm_h2[o] = 0;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  ptrs holds the kPointers device
// pointers of Args, in its order, each a contiguous array of the shape
// noted there (done, suss, bm_valid and bm_on one byte an entry); B lanes,
// one block each.  Launches on `stream` and returns the cudaError_t of the
// launch (0 on success).
extern "C" int rafft_enumerate(void* const* ptrs, int nptrs, int B, int K,
                               int R, int M, int V, int W, int S,
                               long long max_branch, void* stream) {
  if (nptrs != kPointers) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  if (K < 1 || K > kMaxK || R < 1 || R > kMaxR || V < K || V > kMaxV
      || M < 1 || M > 65535 || W < 1 || S < 1 || S > kMaxS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args in;
  void** dst = reinterpret_cast<void**>(&in);
  for (int i = 0; i < kPointers; ++i) dst[i] = ptrs[i];
  const Dims d{K, R, M, V, W, S, max_branch};
  const size_t smem = enumerate_layout(V, K, R, S).total;
  if (smem + sizeof(Lane) > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the opt-in above 48 KB holds for the current device only: set it on
  // every launch
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        enumerate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = min(kMaxThreads, max(kMinThreads, pow2ceil(V) / 2));
  enumerate_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, d);
  return static_cast<int>(cudaGetLastError());
}
