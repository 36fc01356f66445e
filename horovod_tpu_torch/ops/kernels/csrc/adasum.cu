// Adasum combine of gradient vectors, segment by segment, for Hopper (sm_90a).
//
// Replaces the TPU kernel horovod_tpu/ops/pallas/kernels.py::_adasum_kernel
// (via adasum_combine_pallas), the reference's pairwise combine of
// horovod/common/ops/adasum/adasum.h:103+. A unit is one segment (one tensor
// of a fusion bucket) of one pair of vectors (a, b); for every unit on its
// own:
//
//   dot = sum a*b,  na = sum a*a,  nb = sum b*b                      (fp32)
//   ca  = na > eps ? 1 - dot / (2 max(na, eps)) : 1,  cb likewise
//   out = T(ca*a + cb*b)       (two fp32 products, one fp32 add, one rounding)
//
// T is float, __half, __nv_bfloat16 or double; every element is read into
// fp32, as the JAX combine casts to fp32 whatever its input. One launch takes
// every unit of an Adasum tree level: each pair (row i, row i + s) of a
// gathered bucket times each segment, out aliasing row i.
//
// Bound: bytes. The least the function needs is one read of a and b and one
// write of out, 3 N itemsize bytes (92 us for ResNet-50's 25.6M fp32
// gradients at 3.35 TB/s); a handful of flops per element is far below the
// card's balance point. A unit's coefficients need all of its sums before
// any of its output, so a kernel that streams reads a and b twice (5 N).
//
// The design, hvd_adasum_level: a persistent grid, launched cooperatively so
// that every CTA is resident at once, walks a host-built schedule of tiles.
// Tile t goes to CTA t % grid at step t / grid. Each CTA holds kBuffers
// tiles at once in shared memory (its current step's and the next ones'),
// so a round (what the grid holds at once) is kBuffers steps, and a unit
// that fits in a round has all of its tiles within kBuffers consecutive
// steps (the host pads a step otherwise). Each CTA, for each of its tiles:
//
//   1. copies its part of a and b into shared memory (16-byte cp.async, the
//      ragged head and tail of a row that is not 16-byte aligned by scalar
//      loads; each array keeps its own alignment in its region);
//   2. reduces dot, na and nb in fp32 (each thread strided over the tile,
//      warp shuffles, then the warps in order) into the tile's slot;
//   3. arrives on the unit's counter (a device-scope release add that
//      nobody waits for). The CTA of the unit's last tile, in the unit's
//      latest step, waits for the counter, sums the unit's slots in tile
//      order (thread k slots k, k + threads, ..., then the block's fixed
//      order, so the result is deterministic) and publishes ca and cb as
//      two 64-bit words tagged with the launch's epoch;
//   4. a step later, while its next tile's copies are in flight, reads its
//      unit's two words until they carry this epoch, and writes out
//      ca a + cb b from shared memory, 16-byte stores where out is aligned.
//
// So a and b are read from device memory once. Counters count on across
// launches (launch e finds a unit complete at e * ntiles arrivals) and the
// coefficient words carry their epoch, so nothing is cleared between
// launches. A CTA never waits on a unit before it has arrived on every tile
// of that unit in its own steps, so the units complete whatever the CTAs'
// order. Four CTAs of 52 KB share an SM.
//
// A unit longer than a round takes the streaming route instead, chosen on
// the host before any launch: hvd_adasum_partials (each block's three sums
// over its share of the unit) then hvd_adasum_apply (each block sums its
// unit's partials in a fixed order, then writes its share), which reads a
// and b twice.
//
// out may alias a: the level kernel reads each tile of a into shared memory
// in the CTA that writes it, and nothing else reads that part of a; in the
// streaming route each element is read and written by one thread and
// nothing reads a after the apply pass. out may not alias b.
//
// Plain C interface, loaded with ctypes; each entry point returns a
// cudaError_t, that of its launch. Nothing is allocated here and nothing
// synchronises.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cvt.cuh"

namespace {

struct Sums {
  float dot, na, nb;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sums, in a fixed order, valid in every thread. The caller
// synchronises before ``part`` is written again.
template <int kWarps>
__device__ __forceinline__ Sums block_sum(Sums s, float (*part)[kWarps]) {
  s.dot = warp_sum(s.dot);
  s.na = warp_sum(s.na);
  s.nb = warp_sum(s.nb);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[0][warp] = s.dot;
    part[1][warp] = s.na;
    part[2][warp] = s.nb;
  }
  __syncthreads();
  Sums r{0.f, 0.f, 0.f};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    r.dot += part[0][w];
    r.na += part[1][w];
    r.nb += part[2][w];
  }
  return r;
}

__device__ __forceinline__ float coefficient(float dot, float n, float eps) {
  // 1 - dot / (2 max(n, eps)) where n > eps, else 1; IEEE division.
  return n > eps ? __fsub_rn(1.f, __fdiv_rn(dot, __fmul_rn(2.f, fmaxf(n, eps)))) : 1.f;
}

template <typename T>
__device__ __forceinline__ T combine(float ca, float cb, T x, T y) {
  return Cvt<T>::from_f32(
      __fadd_rn(__fmul_rn(ca, Cvt<T>::to_f32(x)), __fmul_rn(cb, Cvt<T>::to_f32(y))));
}

// ---------------------------------------------------------------------------
// The level kernel
// ---------------------------------------------------------------------------

struct Tile {
  int64_t a_off;   // the tile's first element in a (and in out)
  int64_t b_off;   // its first element in b
  int32_t len;     // its elements; 0 for a slot its step leaves empty
  int32_t unit;    // the unit it belongs to
  int32_t first;   // the unit's first tile
  uint32_t ntiles : 31;  // the unit's tiles
  uint32_t late : 1;     // 1 if the unit has tiles kBuffers - 1 steps on
};

constexpr int kLevelThreads = 256;
// Tiles a CTA holds at once (a and b of each): its current step's and the
// next kBuffers - 1 steps'.
constexpr int kBuffers = 2;
constexpr int kLevelWarps = kLevelThreads / 32;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Elements of T between p and the 16-byte boundary at or below it.
template <typename T>
__device__ __forceinline__ int misalign(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// s[m + i] = g[i] for i < len, where m = misalign(g), so that g - m and s
// are both 16-byte aligned: whole 16-byte chunks by cp.async, the ragged
// head and tail by scalar loads.
template <typename T>
__device__ __forceinline__ void load_tile(T* s, const T* g, int m, int len) {
  constexpr int V = 16 / sizeof(T);
  const T* base = g - m;
  const int n = m + len;
  const int lo = (m + V - 1) / V, hi = n / V;  // the chunks wholly inside
  for (int c = lo + threadIdx.x; c < hi; c += kLevelThreads) cp_async16(s + c * V, base + c * V);
  const int head_end = min(lo * V, n);
  for (int i = m + threadIdx.x; i < head_end; i += kLevelThreads) s[i] = base[i];
  for (int i = max(hi, lo) * V + threadIdx.x; i < n; i += kLevelThreads) s[i] = base[i];
}

// out[i] = ca a[i] + cb b[i] for i < len, a and b in shared memory at their
// offsets ma and mb; 16-byte stores over out's aligned chunks.
template <typename T>
__device__ __forceinline__ void store_tile(T* out, const T* sa, int ma, const T* sb, int mb,
                                           int len, float ca, float cb) {
  constexpr int V = 16 / sizeof(T);
  const int mo = misalign(out);
  T* base = out - mo;
  const int n = mo + len;
  const int lo = (mo + V - 1) / V, hi = n / V;
  const T* pa = sa + ma - mo;  // pa[j] pairs with base[j]
  const T* pb = sb + mb - mo;
  for (int c = lo + threadIdx.x; c < hi; c += kLevelThreads) {
    alignas(16) T e[V];
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = combine(ca, cb, pa[c * V + j], pb[c * V + j]);
    *reinterpret_cast<uint4*>(base + c * V) = *reinterpret_cast<const uint4*>(e);
  }
  const int head_end = min(lo * V, n);
  for (int i = mo + threadIdx.x; i < head_end; i += kLevelThreads)
    base[i] = combine(ca, cb, pa[i], pb[i]);
  for (int i = max(hi, lo) * V + threadIdx.x; i < n; i += kLevelThreads)
    base[i] = combine(ca, cb, pa[i], pb[i]);
}

using AtomicU64 = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

// A unit's coefficients travel as two 64-bit words, each the launch's
// epoch (its low 32 bits) over one fp32 coefficient, so one read of the
// pair both sees that they are this launch's and carries them.
__device__ __forceinline__ unsigned long long tagged(unsigned long long epoch, float c) {
  return (epoch & 0xffffffffull) << 32 | __float_as_uint(c);
}

// Thread 0: the tile's unit's coefficients, once its last tile has
// published them. No CTA waits on a unit before it has arrived on every
// tile of it in its own steps, so the last tile arrives within
// microseconds; a wait of seconds means a broken schedule, and the kernel
// traps (the launch then fails) rather than hang the card.
__device__ __forceinline__ float2 await_coef(const Tile& tile, unsigned long long* words,
                                             unsigned long long epoch) {
  AtomicU64 wa(words[2 * tile.unit]), wb(words[2 * tile.unit + 1]);
  const unsigned long long tag = epoch & 0xffffffffull;
  for (long long spins = 0;; ++spins) {
    const unsigned long long ca = wa.load(cuda::memory_order_relaxed);
    const unsigned long long cb = wb.load(cuda::memory_order_relaxed);
    if (ca >> 32 == tag && cb >> 32 == tag)
      return make_float2(__uint_as_float(static_cast<unsigned>(ca)),
                         __uint_as_float(static_cast<unsigned>(cb)));
    if (spins > (1ll << 26)) __trap();
    __nanosleep(32);
  }
}

// A tile whose copies are in flight or have landed: its row and where a
// and b start in their regions (their misalignment).
struct Staged {
  Tile tile;
  int ma, mb;
};

template <typename T>
__device__ __forceinline__ Staged stage(const Tile& tile, const T* a, const T* b, T* sa, T* sb) {
  Staged st{tile, 0, 0};
  if (tile.len) {
    const T* ga = a + tile.a_off;
    const T* gb = b + tile.b_off;
    st.ma = misalign(ga);
    st.mb = misalign(gb);
    load_tile(sa, ga, st.ma, tile.len);
    load_tile(sb, gb, st.mb, tile.len);
  }
  return st;
}

// The tile's sums into its slot, then its arrival on its unit (thread 0, a
// device-scope release add on the unit's counter, whose result nobody waits
// for; launch e finds the unit complete when the counter reaches
// e * ntiles, so nothing is cleared between launches). The CTA that holds
// the unit's last tile, in the unit's latest step, finishes it: it waits
// for the counter, sums the unit's slots (thread k slots k, k + threads,
// ... in order, then the block's fixed order) and thread 0 publishes the
// coefficients. Called after the tile's copies have landed and a barrier.
template <typename T>
__device__ __forceinline__ void reduce_arrive(const Staged& st, int64_t t, const T* sa,
                                              const T* sb, float (*part)[kLevelWarps],
                                              float* slots,
                                              unsigned long long* counts,
                                              unsigned long long* words, unsigned long long epoch,
                                              float eps) {
  Sums s{0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < st.tile.len; i += kLevelThreads) {
    const float x = Cvt<T>::to_f32(sa[st.ma + i]);
    const float y = Cvt<T>::to_f32(sb[st.mb + i]);
    s.dot = fmaf(x, y, s.dot);
    s.na = fmaf(x, x, s.na);
    s.nb = fmaf(y, y, s.nb);
  }
  s = block_sum<kLevelWarps>(s, part);
  if (threadIdx.x == 0) {
    float* slot = slots + 3 * t;
    __stcg(slot, s.dot);
    __stcg(slot + 1, s.na);
    __stcg(slot + 2, s.nb);
    AtomicU64(counts[st.tile.unit]).fetch_add(1ull, cuda::memory_order_release);
  }
  if (t != static_cast<int64_t>(st.tile.first) + st.tile.ntiles - 1) return;
  if (threadIdx.x == 0) {
    // The unit's other tiles lie in this step or earlier ones, and their
    // CTAs arrive on them before they wait for anything of this step.
    AtomicU64 count(counts[st.tile.unit]);
    const unsigned long long all = epoch * static_cast<unsigned long long>(st.tile.ntiles);
    for (long long spins = 0; count.load(cuda::memory_order_acquire) != all; ++spins) {
      if (spins > (1ll << 26)) __trap();
      __nanosleep(32);
    }
  }
  __syncthreads();
  // Every slot of the unit is in: thread 0's load acquired them, and each
  // thread's fence orders its loads after that and the barrier.
  cuda::atomic_thread_fence(cuda::memory_order_acquire, cuda::thread_scope_device);
  Sums u{0.f, 0.f, 0.f};
  for (int k = threadIdx.x; k < static_cast<int>(st.tile.ntiles); k += kLevelThreads) {
    const float* p = slots + 3 * (static_cast<int64_t>(st.tile.first) + k);
    u.dot += __ldcg(p);
    u.na += __ldcg(p + 1);
    u.nb += __ldcg(p + 2);
  }
  u = block_sum<kLevelWarps>(u, part);
  if (threadIdx.x == 0) {
    AtomicU64(words[2 * st.tile.unit])
        .store(tagged(epoch, coefficient(u.dot, u.na, eps)), cuda::memory_order_relaxed);
    AtomicU64(words[2 * st.tile.unit + 1])
        .store(tagged(epoch, coefficient(u.dot, u.nb, eps)), cuda::memory_order_relaxed);
  }
}

// Thread 0 waits for the tile's coefficients, then the CTA writes it out.
template <typename T>
__device__ __forceinline__ void await_store(const Staged& st, T* out, const T* sa, const T* sb,
                                            float2* shared_coef, unsigned long long* words,
                                            unsigned long long epoch) {
  if (threadIdx.x == 0) *shared_coef = await_coef(st.tile, words, epoch);
  __syncthreads();
  const float2 c = *shared_coef;
  store_tile(out + st.tile.a_off, sa, st.ma, sb, st.mb, st.tile.len, c.x, c.y);
}

// Each CTA walks its tiles t = blockIdx.x, + grid, ... with kBuffers
// buffers (2 kBuffers regions of region_bytes: a and b of each), so its
// tiles of steps r .. r + kBuffers - 1 are in shared memory together. At
// step r it starts the copies of its step r + kBuffers - 1 tile; writes out
// its step r tile while they are in flight, if that tile's unit has arrived
// in full by the previous step (its tiles lie in steps up to
// r + kBuffers - 2); then reduces the new tile and arrives on it; and only
// then writes out a step r tile whose unit goes on into step
// r + kBuffers - 1 (late). The row of the next tile to copy is read a step
// ahead. No CTA waits on a unit before it has arrived on every tile of it
// in its own steps, so the units complete whatever the CTAs' order; a unit
// may take kBuffers consecutive steps: a round, what the grid holds at
// once.
template <typename T>
__global__ void __launch_bounds__(kLevelThreads, 4)
adasum_level_kernel(const Tile* __restrict__ tiles, int64_t n_tiles, const T* a, const T* b,
                    T* out, float* slots, unsigned long long* counts, unsigned long long* words,
                    unsigned long long epoch, int region_bytes, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part[3][kLevelWarps];
  __shared__ float2 shared_coef;
  __shared__ Staged meta[kBuffers];  // the tile in each buffer
  auto region = [&](int i) { return reinterpret_cast<T*>(smem + i * region_bytes); };
  const int64_t grid = gridDim.x;
  int64_t t = blockIdx.x;
  if (t >= n_tiles) return;
  const Tile none{0, 0, 0, 0, 0, 0, 0};
  for (int k = 0; k < kBuffers - 1; ++k) {
    const int64_t tk = t + k * grid;
    const Staged st = stage(tk < n_tiles ? tiles[tk] : none, a, b, region(2 * k),
                            region(2 * k + 1));
    if (threadIdx.x == 0) meta[k] = st;
  }
  cp_async_wait_all();
  __syncthreads();
  for (int k = 0; k < kBuffers - 1; ++k) {
    const Staged st = meta[k];
    if (st.tile.len)
      reduce_arrive(st, t + k * grid, region(2 * k), region(2 * k + 1), part, slots,
                    counts, words, epoch, eps);
  }
  int64_t tf = t + (kBuffers - 1) * grid;  // the next tile to copy
  Tile ahead = tf < n_tiles ? tiles[tf] : none;
  int buf = 0;                              // the buffer of step r
  for (; t < n_tiles; t += grid, tf += grid) {
    const int fb = (buf + kBuffers - 1) % kBuffers;
    const Tile row = ahead;
    ahead = tf + grid < n_tiles ? tiles[tf + grid] : none;
    const Staged fut = stage(row, a, b, region(2 * fb), region(2 * fb + 1));
    if (threadIdx.x == 0) meta[fb] = fut;  // buffer fb's last reader was step r - 1
    const Staged cur = meta[buf];
    if (cur.tile.len && !cur.tile.late)
      await_store(cur, out, region(2 * buf), region(2 * buf + 1), &shared_coef, words, epoch);
    cp_async_wait_all();
    __syncthreads();
    if (fut.tile.len)
      reduce_arrive(fut, tf, region(2 * fb), region(2 * fb + 1), part, slots, counts,
                    words, epoch, eps);
    if (cur.tile.len && cur.tile.late)
      await_store(cur, out, region(2 * buf), region(2 * buf + 1), &shared_coef, words, epoch);
    __syncthreads();  // buffer buf, part and shared_coef free for the next step
    buf = (buf + 1) % kBuffers;
  }
}

template <typename T>
int level_config(int smem_bytes, int* grid) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(adasum_level_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adasum_level_kernel<T>,
                                                      kLevelThreads, smem_bytes);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  *grid = per_sm * sms;
  return 0;
}

template <typename T>
int level(const void* tiles, int64_t n_tiles, int grid, const void* a, const void* b, void* out,
          void* slots, void* sync, int64_t n_units, unsigned long long epoch, int region_bytes,
          float eps, cudaStream_t stream) {
  const Tile* t = static_cast<const Tile*>(tiles);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* po = static_cast<T*>(out);
  float* ps = static_cast<float*>(slots);
  unsigned long long* counts = static_cast<unsigned long long*>(sync);
  unsigned long long* words = counts + n_units;
  void* args[] = {&t, &n_tiles, &pa, &pb, &po, &ps, &counts, &words, &epoch, &region_bytes, &eps};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(adasum_level_kernel<T>), dim3(grid), dim3(kLevelThreads), args,
      static_cast<size_t>(2 * kBuffers) * region_bytes, stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// ---------------------------------------------------------------------------
// The streaming route: units longer than a round
// ---------------------------------------------------------------------------

// One int64 row per block: its unit's offsets in a (and out) and b, the
// unit's length, its first block and its number of blocks.
struct Row {
  int64_t a_off, b_off, numel, first, nblocks;
};

constexpr int kStreamThreads = 256;
constexpr int kStreamWarps = kStreamThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
adasum_partials_kernel(const Row* __restrict__ table, int64_t n_blocks, const T* a, const T* b,
                       float* __restrict__ partials) {
  __shared__ float part[3][kStreamWarps];
  const Row r = table[blockIdx.x];
  const int64_t stride = r.nblocks * kStreamThreads;
  const T* sa = a + r.a_off;
  const T* sb = b + r.b_off;
  Sums s{0.f, 0.f, 0.f};
  for (int64_t i = (blockIdx.x - r.first) * kStreamThreads + threadIdx.x; i < r.numel;
       i += stride) {
    const float x = Cvt<T>::to_f32(sa[i]);
    const float y = Cvt<T>::to_f32(sb[i]);
    s.dot = fmaf(x, y, s.dot);
    s.na = fmaf(x, x, s.na);
    s.nb = fmaf(y, y, s.nb);
  }
  s = block_sum<kStreamWarps>(s, part);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s.dot;
    partials[n_blocks + blockIdx.x] = s.na;
    partials[2 * n_blocks + blockIdx.x] = s.nb;
  }
}

template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
adasum_apply_kernel(const Row* __restrict__ table, int64_t n_blocks, const T* a, const T* b,
                    T* out, const float* __restrict__ partials, float eps) {
  __shared__ float part[3][kStreamWarps];
  const Row r = table[blockIdx.x];
  Sums s{0.f, 0.f, 0.f};
  for (int64_t k = threadIdx.x; k < r.nblocks; k += kStreamThreads) {
    s.dot += partials[r.first + k];
    s.na += partials[n_blocks + r.first + k];
    s.nb += partials[2 * n_blocks + r.first + k];
  }
  s = block_sum<kStreamWarps>(s, part);
  const float ca = coefficient(s.dot, s.na, eps);
  const float cb = coefficient(s.dot, s.nb, eps);
  const int64_t stride = r.nblocks * kStreamThreads;
  const T* sa = a + r.a_off;
  const T* sb = b + r.b_off;
  T* so = out + r.a_off;
  for (int64_t i = (blockIdx.x - r.first) * kStreamThreads + threadIdx.x; i < r.numel;
       i += stride)
    so[i] = combine(ca, cb, sa[i], sb[i]);
}

bool valid_grid(int64_t n_blocks) { return n_blocks > 0 && n_blocks <= 0x7fffffff; }

template <typename T>
void partials(const void* table, int64_t n_blocks, const void* a, const void* b, void* p,
              cudaStream_t stream) {
  adasum_partials_kernel<T><<<static_cast<unsigned>(n_blocks), kStreamThreads, 0, stream>>>(
      static_cast<const Row*>(table), n_blocks, static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<float*>(p));
}

template <typename T>
void apply(const void* table, int64_t n_blocks, const void* a, const void* b, void* out,
           const void* p, float eps, cudaStream_t stream) {
  adasum_apply_kernel<T><<<static_cast<unsigned>(n_blocks), kStreamThreads, 0, stream>>>(
      static_cast<const Row*>(table), n_blocks, static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<T*>(out), static_cast<const float*>(p), eps);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16, 3 = float64.

// The level kernel's grid on the current device: the CTAs of
// smem_bytes dynamic shared memory that fit on an SM at once, times the SMs.
// Sets the kernel's dynamic shared memory limit; fails where the device
// has no cooperative launch.
int hvd_adasum_level_grid(int dtype, int smem_bytes, int* grid) {
  switch (dtype) {
    case 0: return level_config<float>(smem_bytes, grid);
    case 1: return level_config<__half>(smem_bytes, grid);
    case 2: return level_config<__nv_bfloat16>(smem_bytes, grid);
    case 3: return level_config<double>(smem_bytes, grid);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One cooperative launch over a schedule's tiles (n_tiles rows of Tile).
// slots: 3 n_tiles fp32; sync: 3 n_units uint64 (a counter a unit, then two
// tagged coefficient words a unit), zero before the schedule's first
// launch; epoch: 1 for the schedule's first launch, one more for each
// launch after.
int hvd_adasum_level(const void* tiles, int64_t n_tiles, int grid, const void* a, const void* b,
                     void* out, void* slots, void* sync, int64_t n_units,
                     unsigned long long epoch, int region_bytes, int dtype, float eps,
                     void* stream) {
  if (n_tiles <= 0 || grid <= 0 || epoch == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return level<float>(tiles, n_tiles, grid, a, b, out, slots, sync, n_units, epoch,
                          region_bytes, eps, s);
    case 1:
      return level<__half>(tiles, n_tiles, grid, a, b, out, slots, sync, n_units, epoch,
                           region_bytes, eps, s);
    case 2:
      return level<__nv_bfloat16>(tiles, n_tiles, grid, a, b, out, slots, sync, n_units, epoch,
                                  region_bytes, eps, s);
    case 3:
      return level<double>(tiles, n_tiles, grid, a, b, out, slots, sync, n_units, epoch,
                           region_bytes, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The streaming route. partials: 3 * n_blocks fp32.
int hvd_adasum_partials(const void* table, int64_t n_blocks, const void* a, const void* b,
                        void* partials_out, int dtype, void* stream) {
  if (!valid_grid(n_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: partials<float>(table, n_blocks, a, b, partials_out, s); break;
    case 1: partials<__half>(table, n_blocks, a, b, partials_out, s); break;
    case 2: partials<__nv_bfloat16>(table, n_blocks, a, b, partials_out, s); break;
    case 3: partials<double>(table, n_blocks, a, b, partials_out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int hvd_adasum_apply(const void* table, int64_t n_blocks, const void* a, const void* b, void* out,
                     const void* partials_in, int dtype, float eps, void* stream) {
  if (!valid_grid(n_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: apply<float>(table, n_blocks, a, b, out, partials_in, eps, s); break;
    case 1: apply<__half>(table, n_blocks, a, b, out, partials_in, eps, s); break;
    case 2: apply<__nv_bfloat16>(table, n_blocks, a, b, out, partials_in, eps, s); break;
    case 3: apply<double>(table, n_blocks, a, b, out, partials_in, eps, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
