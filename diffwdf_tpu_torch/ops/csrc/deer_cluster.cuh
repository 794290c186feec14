// The single-stream DEER solve on a thread-block cluster: the passes of one
// CTA, shared by the LPF clipper's kernel (parallel_time_deer.cu, B5 in
// ROADMAP) and the generated circuit kernels (ops/circuit_codegen.py
// generate_deer, B9).
//
// The recursion z_t = F(z_{t-1}, v_t) of S states over one block of T = 1024 L
// samples is solved by Newton over the whole trajectory: linearised around
// the current guess, z_t = J_t z_{t-1} + c_t with c_t = F(z^_{t-1}) - J_t
// z^_{t-1}, and the affine recurrence solved exactly by composing the maps.
// The JAX kernel's partition stays: 1024 contiguous time blocks of L samples,
// the unit of a relaxation and of the block scan.  A cluster of C CTAs on
// neighbouring SMs shares them out: CTA k owns blocks [k NB, (k + 1) NB),
// NB = 1024 / C, the time range [k T / C, (k + 1) T / C).  One solve:
//   stage   every thread copies samples of the CTA's range into the
//           (L, 1024) scratch and zeroes the first trajectory buffer; the
//           CTAs' max|v| are combined through distributed shared memory, so
//           that every CTA gets the same bound;
//   relax   relax_passes nonlinear block relaxations: one thread per block
//           runs the recursion over its L rows from the previous iterate's
//           block start, reading one trajectory buffer and writing the other
//           (ping-pong: one cluster barrier a pass);
//   sweep   a. the step pass, sample-parallel: at every sample f_t and J_t at
//              z_{t-1} and c_t = f_t - J_t z_{t-1}, into the scratch;
//           b. one thread per block composes its rows, row 0 first, into the
//              within-block prefixes, in place;
//           c. the CTA's exclusive scan of its NB block totals (deer_warp_scan
//              in each warp, then the earlier warps' totals) and the CTA's
//              total in shared memory; a cluster barrier;
//           d. each block's start state: the initial state carried through
//              the totals of CTAs 0 .. k-1 in order (copied in through
//              distributed shared memory; earlier first), then through the
//              block's exclusive prefix;
//           e. the apply pass, sample-parallel: z_t = P_t(block start),
//              clamped to +-bound (a NaN stays NaN), damped z <- z_old +
//              d (z_new - z_old), into the other buffer, with the largest
//              update; a cluster barrier, after which every CTA combines all
//              C largest updates in one order, so that every CTA takes the
//              same exit decision in the adaptive loop;
//   emit    sample-parallel: the output at z_{t-1}, the residual
//           max|F(z_{t-1}) - z_t| (NaN kept, combined across the cluster),
//           the final state and the sweeps run.
// Two cluster barriers a sweep.  Global memory written before a cluster
// barrier (barrier.cluster.arrive.release / wait.acquire) is visible after it
// to every CTA of the cluster: the step pass, a relaxation and the emit pass
// read the neighbouring CTA's last z.
//
// The relaxations and the emit pass run each block's chain with the step's
// expressions, so with sweeps = 0 a solve has the bits of one thread walking
// the blocks one after another.  A sweep composes the block totals in another
// order than such a walk (and than the TPU's lane-then-sublane doublings), so
// results agree to rounding.
//
// A Step gives, for its S states:
//   float bound(float vmax)          the clamp bound from max|v|;
//   void relax(float v, float* z)    z <- F(z, v);
//   void lin(float v, const float* z, float* f, float* J)
//                                    f = F(z, v), J = dF/dz (row-major);
//   float emit(float v, const float* prev, float* f, const float* z)
//                                    f = F(prev, v); the output sample, z the
//                                    iterate at the same t.
// Everything above deer_cluster_solve is plain C: with the CUDA qualifiers
// defined away it compiles for the host (tests/test_torch_deer_kernels.py
// walks the CTAs one after another with it).

#pragma once

#include <cuda_runtime.h>

#include "deer_scan.cuh"

namespace {

constexpr int kDeerBlocks = 1024;  // time blocks of the partition

// The scratch of one solve, (L, 1024) row-major arrays of T = 1024 L floats:
// element (r, b) is sample b L + r.
template <int S>
struct DeerScratch {
  float* V;   // the input
  float* Z;   // two trajectory buffers: state k of buffer q at Z + (q S + k) T
  float* JC;  // J_t (S x S row-major), then c_t: (S^2 + S) T; in place, the prefixes
  size_t T;
  int L;

  __device__ __forceinline__ size_t at(int r, int b) const {
    return static_cast<size_t>(r) * kDeerBlocks + b;
  }
  __device__ __forceinline__ float* z(int q, int k) const {
    return Z + (static_cast<size_t>(q) * S + k) * T;
  }
};

// Floats of the scratch: the input, two trajectories, the rows.
template <int S>
constexpr size_t deer_scratch_floats(size_t T) {
  return (1 + 3 * S + S * S) * T;
}

// The guess at the sample before (r, b) in buffer q: z_(r-1, b), for r = 0
// block b-1's last, for block 0 the initial state.
template <int S>
__device__ __forceinline__ void deer_prev(const DeerScratch<S>& g, int q, int r, int b,
                                          const float* s0, float* z) {
  if (r == 0 && b == 0) {
#pragma unroll
    for (int k = 0; k < S; ++k) z[k] = s0[k];
    return;
  }
  const size_t i = r > 0 ? g.at(r - 1, b) : g.at(g.L - 1, b - 1);
#pragma unroll
  for (int k = 0; k < S; ++k) z[k] = g.z(q, k)[i];
}

// Stage sample i of the CTA's time range (from block `first` on) and zero
// buffer 0 there; returns |v|.
template <int S>
__device__ __forceinline__ float deer_stage(const DeerScratch<S>& g, int first, int i,
                                            const float* vin) {
  const size_t t = static_cast<size_t>(first) * g.L + i;
  const int b = static_cast<int>(t / g.L);
  const int r = static_cast<int>(t - static_cast<size_t>(b) * g.L);
  const float x = vin[t];
  g.V[g.at(r, b)] = x;
#pragma unroll
  for (int k = 0; k < S; ++k) g.z(0, k)[g.at(r, b)] = 0.f;
  return fabsf(x);
}

// One relaxation of block b: the recursion over its L rows from buffer q's
// block start, into buffer q ^ 1.
template <int S, class Step>
__device__ __forceinline__ void deer_relax(const Step& st, const DeerScratch<S>& g, int q, int b,
                                           const float* s0) {
  float z[S];
  deer_prev(g, q, 0, b, s0, z);
  for (int r = 0; r < g.L; ++r) {
    const size_t i = g.at(r, b);
    st.relax(g.V[i], z);
#pragma unroll
    for (int k = 0; k < S; ++k) g.z(q ^ 1, k)[i] = z[k];
  }
}

// The step pass at (r, b): f and J at buffer q's z_(t-1), c = f - J z_(t-1).
template <int S, class Step>
__device__ __forceinline__ void deer_linearise(const Step& st, const DeerScratch<S>& g, int q,
                                               int r, int b, const float* s0) {
  float prev[S], f[S], J[S * S];
  deer_prev(g, q, r, b, s0, prev);
  const size_t i = g.at(r, b);
  st.lin(g.V[i], prev, f, J);
#pragma unroll
  for (int m = 0; m < S * S; ++m) g.JC[m * g.T + i] = J[m];
#pragma unroll
  for (int a = 0; a < S; ++a) {
    float jz = __fmul_rn(J[a * S], prev[0]);
#pragma unroll
    for (int k = 1; k < S; ++k) jz = __fadd_rn(jz, __fmul_rn(J[a * S + k], prev[k]));
    g.JC[(S * S + a) * g.T + i] = __fsub_rn(f[a], jz);
  }
}

template <int S>
__device__ __forceinline__ DeerAffine<S> deer_load_row(const DeerScratch<S>& g, int r, int b) {
  DeerAffine<S> x;
  const size_t i = g.at(r, b);
#pragma unroll
  for (int m = 0; m < S * S; ++m) x.J[m] = g.JC[m * g.T + i];
#pragma unroll
  for (int a = 0; a < S; ++a) x.c[a] = g.JC[(S * S + a) * g.T + i];
  return x;
}

// Block b's rows composed into its within-block prefixes, row 0 first, in
// place; returns the block's total.  The next row's loads do not depend on
// the running product: they are issued before it.
template <int S>
__device__ __forceinline__ DeerAffine<S> deer_prefix(const DeerScratch<S>& g, int b) {
  DeerAffine<S> acc = deer_identity<S>();
  DeerAffine<S> row = deer_load_row(g, 0, b);
  for (int r = 0; r < g.L; ++r) {
    const DeerAffine<S> next = deer_load_row(g, r + 1 < g.L ? r + 1 : r, b);
    acc = deer_compose(acc, row);
    const size_t i = g.at(r, b);
#pragma unroll
    for (int m = 0; m < S * S; ++m) g.JC[m * g.T + i] = acc.J[m];
#pragma unroll
    for (int a = 0; a < S; ++a) g.JC[(S * S + a) * g.T + i] = acc.c[a];
    row = next;
  }
  return acc;
}

// The scan of the CTA's block totals, part 1, by every lane of a warp that
// holds totals: the inclusive scan inside the warp (deer_warp_scan), lane 31
// storing the warp's total; returns the exclusive prefix inside the warp.
template <int S>
__device__ __forceinline__ DeerAffine<S> deer_scan_in_warp(const DeerAffine<S>& x, int lane,
                                                           DeerAffine<S>* warp_total) {
  const DeerAffine<S> inc = deer_warp_scan(x, lane);
  if (lane == 31) *warp_total = inc;
  DeerAffine<S> ex = deer_shfl_up(inc, 1);
  if (lane == 0) ex = deer_identity<S>();
  return ex;
}

// Part 2, after a barrier: the totals of warps 0 .. warp-1 composed in order
// (earlier first), then the in-warp prefix: the blocks before this one in
// the CTA.
template <int S>
__device__ __forceinline__ DeerAffine<S> deer_scan_across_warps(const DeerAffine<S>& ex, int warp,
                                                                const DeerAffine<S>* warp_totals) {
  if (warp == 0) return ex;
  DeerAffine<S> pre = warp_totals[0];
  for (int u = 1; u < warp; ++u) pre = deer_compose(pre, warp_totals[u]);
  return deer_compose(pre, ex);
}

// The CTA's total: its n_warps warp totals composed in order.
template <int S>
__device__ __forceinline__ DeerAffine<S> deer_cta_total(const DeerAffine<S>* warp_totals,
                                                        int n_warps) {
  DeerAffine<S> tot = warp_totals[0];
  for (int u = 1; u < n_warps; ++u) tot = deer_compose(tot, warp_totals[u]);
  return tot;
}

// Block b's start state: s0 through the totals of CTAs 0 .. k-1 in order
// (total(m) points at CTA m's), then through the block's exclusive prefix ex
// inside its CTA.  Carrying the state (S^2 a CTA) rather than composing the
// maps (S^3) is the same affine map, rounded on the way.
template <int S, class Totals>
__device__ __forceinline__ void deer_block_start(const float* s0, int k, Totals total,
                                                 const DeerAffine<S>& ex, float* zs) {
  float z[S], y[S];
#pragma unroll
  for (int a = 0; a < S; ++a) z[a] = s0[a];
  for (int m = 0; m < k; ++m) {
    deer_apply(*total(m), z, y);
#pragma unroll
    for (int a = 0; a < S; ++a) z[a] = y[a];
  }
  deer_apply(ex, z, zs);
}

// The apply pass at (r, b): z_t = P_t(zs), clamped to +-bound (NaN kept),
// damped against buffer q's z_t, into buffer q ^ 1; returns |update| when
// tracked (else 0).
template <int S>
__device__ __forceinline__ float deer_update(const DeerScratch<S>& g, int q, int r, int b,
                                             const float* zs, float bound, float damping,
                                             bool track) {
  const size_t i = g.at(r, b);
  float dmax = 0.f;
#pragma unroll
  for (int a = 0; a < S; ++a) {
    float zn = __fmul_rn(g.JC[a * S * g.T + i], zs[0]);
#pragma unroll
    for (int k = 1; k < S; ++k) zn = __fadd_rn(zn, __fmul_rn(g.JC[(a * S + k) * g.T + i], zs[k]));
    zn = __fadd_rn(zn, g.JC[(S * S + a) * g.T + i]);
    zn = zn < -bound ? -bound : (zn > bound ? bound : zn);  // NaN stays
    const float zo = g.z(q, a)[i];
    if (damping != 1.f) zn = __fadd_rn(zo, __fmul_rn(damping, __fsub_rn(zn, zo)));
    if (track) dmax = deer_nanmax(dmax, fabsf(__fsub_rn(zn, zo)));
    g.z(q ^ 1, a)[i] = zn;
  }
  return dmax;
}

// The emit pass at (r, b) on buffer q: out = the step's output; returns
// max_k |F_k(z_(t-1)) - z_t,k| (NaN kept).
template <int S, class Step>
__device__ __forceinline__ float deer_emit(const Step& st, const DeerScratch<S>& g, int q, int r,
                                           int b, const float* s0, float* out) {
  float prev[S], f[S], z[S];
  deer_prev(g, q, r, b, s0, prev);
  const size_t i = g.at(r, b);
#pragma unroll
  for (int k = 0; k < S; ++k) z[k] = g.z(q, k)[i];
  const float y = st.emit(g.V[i], prev, f, z);
  float res = 0.f;
#pragma unroll
  for (int k = 0; k < S; ++k) res = deer_nanmax(res, fabsf(__fsub_rn(f[k], z[k])));
  out[static_cast<size_t>(b) * g.L + r] = y;
  return res;
}

// One solve's arguments: vin (T,), z0 (S,) in; out (T,), zf (S,), res (1,)
// out, done (1,: the sweeps run) when not null; scratch
// deer_scratch_floats<S>(T); T = 1024 L.  With track the sweeps stop once the
// largest update of the last sweep of a trip of `unroll` falls below tol.
struct DeerArgs {
  const float* vin;
  const float* z0;
  float* out;
  float* zf;
  float* res;
  float* done;
  float* scratch;
  int L;
  int sweeps;
  int relax_passes;
  int unroll;
  float damping;
  float tol;
  int track;
};

// The passes of one solve between the stage and the emit pass, in the order
// the kernel takes them on every CTA (barrier: a cluster barrier) and the
// CPU tests' host walk replays on all CTAs at once (barrier: nothing):
// a.relax_passes relaxations, relax(q) from buffer q into q ^ 1, each
// followed by barrier(); then trips of a.unroll sweeps, sweep(q, reduce)
// from buffer q into q ^ 1, ending at a barrier of its own and returning the
// cluster's largest update when reduce (else 0).  With a.track the last
// sweep of a trip is the exit test, so the sweeps run are a multiple of
// unroll, capped at a.sweeps.  Returns them; q (in and out) is the buffer
// that holds the iterate.
template <class Relax, class Sweep, class Barrier>
__device__ __forceinline__ int deer_passes(const DeerArgs& a, int& q, Relax relax, Sweep sweep,
                                           Barrier barrier) {
  for (int p = 0; p < a.relax_passes; ++p) {
    relax(q);
    barrier();
    q ^= 1;
  }
  const float limit = a.track ? a.tol : -1.f;
  int done = 0;
  float delta = INFINITY;
  while (done < a.sweeps && delta >= limit) {
    for (int u = 0; u < a.unroll; ++u) {
      const float d = sweep(q, a.track && u == a.unroll - 1);
      q ^= 1;
      if (u == a.unroll - 1) delta = d;
    }
    done += a.unroll;
  }
  return done < a.sweeps ? done : a.sweeps;
}

}  // namespace

#ifdef __CUDACC__

#include <cooperative_groups.h>

namespace {

// The whole solve on CTA cluster.block_rank() of a cluster of C CTAs of NT
// threads.  Every CTA runs every barrier: the exit decisions are taken on
// cluster-wide values.
template <int C, int NT, int S, class Step>
__device__ __forceinline__ void deer_cluster_solve(const Step& st, const DeerArgs& a) {
  namespace cg = cooperative_groups;
  constexpr int NB = kDeerBlocks / C;  // time blocks of one CTA
  constexpr int NW = NB / 32;          // warps that hold a block total
  static_assert(kDeerBlocks % C == 0 && NB % 32 == 0 && NB <= NT && NT % 32 == 0,
                "a CTA holds whole warps of blocks");
  using Map = DeerAffine<S>;
  __shared__ Map s_warp[NW];        // the warp totals of the CTA scan
  __shared__ Map s_cta;             // this CTA's total, read by the later CTAs
  __shared__ Map s_before[C];       // the earlier CTAs' totals, copied in
  __shared__ float s_start[NB][S];  // the block start states of a sweep
  __shared__ float s_red[32];
  __shared__ float s_vmax, s_delta, s_res;  // one slot per reduction: no reuse across a barrier
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, first = k * NB, b = first + t;
  const size_t T = static_cast<size_t>(a.L) * kDeerBlocks;
  const DeerScratch<S> g{a.scratch, a.scratch + T, a.scratch + (1 + 2 * S) * T, T, a.L};
  const int n = NB * a.L;  // samples of the CTA
  float s0[S];
#pragma unroll
  for (int i = 0; i < S; ++i) s0[i] = a.z0[i];

  // max of x over the cluster: the CTA's in `slot`, a cluster barrier, then
  // every CTA's in rank order
  auto cluster_max = [&](float x, float* slot) {
    x = deer_block_max(x, s_red);
    if (t == 0) *slot = x;
    cluster.sync();
    float m = *cluster.map_shared_rank(slot, 0);
    for (int j = 1; j < C; ++j) m = deer_nanmax(m, *cluster.map_shared_rank(slot, j));
    return m;
  };

  float vmax = 0.f;
  for (int i = t; i < n; i += NT) vmax = deer_nanmax(vmax, deer_stage(g, first, i, a.vin));
  const float bound = st.bound(cluster_max(vmax, &s_vmax));  // its barrier publishes z

  auto relax = [&](int q) {
    if (t < NB) deer_relax(st, g, q, b, s0);
  };
  auto sweep = [&](int q, bool reduce) {
#pragma unroll 1
    for (int i = t; i < n; i += NT) deer_linearise(st, g, q, i / NB, first + i % NB, s0);
    __syncthreads();
    Map ex;
    if (t < NB) ex = deer_scan_in_warp(deer_prefix(g, b), t & 31, &s_warp[t >> 5]);
    __syncthreads();
    if (t < NB) ex = deer_scan_across_warps(ex, t >> 5, s_warp);
    if (t == 0) s_cta = deer_cta_total(s_warp, NW);
    cluster.sync();  // (1) every CTA's total is readable
    // the earlier CTAs' totals, one float a thread: one round trip through
    // distributed shared memory instead of k dependent ones in each chain
    constexpr int E = S * S + S;
    for (int i = t; i < k * E; i += NT) {
      reinterpret_cast<float*>(s_before)[i] =
          reinterpret_cast<const float*>(cluster.map_shared_rank(&s_cta, i / E))[i % E];
    }
    __syncthreads();
    if (t < NB) deer_block_start(s0, k, [&](int m) { return &s_before[m]; }, ex, s_start[t]);
    __syncthreads();
    float dmax = 0.f;
#pragma unroll 1
    for (int i = t; i < n; i += NT) {
      dmax = deer_nanmax(dmax, deer_update(g, q, i / NB, first + i % NB, s_start[i % NB], bound,
                                           a.damping, a.track != 0));
    }
    if (reduce) return cluster_max(dmax, &s_delta);  // its barrier is (2)
    cluster.sync();  // (2) the new iterate is visible to every CTA
    return 0.f;
  };
  int q = 0;  // the buffer that holds the current iterate
  const int done = deer_passes(a, q, relax, sweep, [&] { cluster.sync(); });

  float res = 0.f;
#pragma unroll 1
  for (int i = t; i < n; i += NT) {
    res = deer_nanmax(res, deer_emit(st, g, q, i / NB, first + i % NB, s0, a.out));
  }
  res = cluster_max(res, &s_res);
  if (k == C - 1 && t == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) a.zf[i] = g.z(q, i)[g.at(a.L - 1, kDeerBlocks - 1)];
  }
  if (k == 0 && t == 0) {
    a.res[0] = res;
    if (a.done) a.done[0] = static_cast<float>(done);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// The launch configuration of one cluster of C CTAs of nt threads.
struct DeerClusterConfig {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];

  DeerClusterConfig(int C, int nt, size_t smem, cudaStream_t stream) : cfg(), attr() {
    cfg.gridDim = dim3(C, 1, 1);
    cfg.blockDim = dim3(nt, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The attributes Kernel needs at C CTAs and smem bytes of dynamic shared
// memory: C = 16 is a non-portable cluster size (allowed once, at the first
// call), and more than 48 KB of shared memory is asked for.
template <int C, auto Kernel>
cudaError_t deer_cluster_attributes(size_t smem) {
  static const cudaError_t allowed =
      C > 8 ? cudaFuncSetAttribute(Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)
            : cudaSuccess;
  if (allowed != cudaSuccess || smem <= 48 * 1024) return allowed;
  return cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launch Kernel(args...) as one cluster of C CTAs of nt threads on `stream`.
// A refused launch returns CUDA's error; nothing falls back.
template <int C, auto Kernel, class... Args>
cudaError_t deer_cluster_launch(int nt, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t e = deer_cluster_attributes<C, Kernel>(smem);
  if (e != cudaSuccess) return e;
  const DeerClusterConfig c(C, nt, smem, stream);
  e = cudaLaunchKernelEx(&c.cfg, Kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters of Kernel at C CTAs of nt threads and smem
// bytes of dynamic shared memory; a negative value is a CUDA error.
template <int C, auto Kernel>
int deer_cluster_max_active(int nt, size_t smem) {
  cudaError_t e = deer_cluster_attributes<C, Kernel>(smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const DeerClusterConfig c(C, nt, smem, nullptr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, Kernel, &c.cfg);
  return e != cudaSuccess ? -static_cast<int>(e) : n;
}

}  // namespace

#endif  // __CUDACC__
