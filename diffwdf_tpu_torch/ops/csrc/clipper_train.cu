// In-circuit training of the LPF diode clipper for Hopper (sm_90a): the
// training forward, its reverse-time adjoint and the MLP parameters'
// cotangents.
//
// Replaces the Pallas TPU kernels
//   train_fwd_lanes_kernel<H, K, L> <- diffwdf_tpu/ops/fused_clipper.py,
//                                      fused_clipper_neural_train_fwd / _neural_train_kernel
//   adjoint_tangent_kernel<H> and adjoint_recursion_kernel
//                                   <- diffwdf_tpu/ops/clipper_train.py, _clipper_adjoint_pallas
// and adds one that replaces no TPU kernel, the adjoint's third pass
//   param_cotangent_kernel<H> and param_sum_kernel: the JAX package leaves
//   this VJP to XLA (diffwdf_tpu/ops/clipper_train.py:272-282), and PyTorch's
//   autograd of the same VJP wrote and read back each (B T, H) activation
//   and cotangent several times in device memory.
//
// Forward recursion per stream (s = capacitor state, p = p1R of the row):
//   b_temp_t = -p (s_t - v_t),  a_t = s_t + b_temp_t,  y_t = MLP([a_t, log R]),
//   s_{t+1} = -y_t + b_temp_t,  o_t = (s_{t+1} + s_t) / 2.
// The source resistance R is per stream (the hoisted per-chunk pot of the
// training data), so p and log R come in as (B,) arrays, and the first
// layer's bias c1 = w1r log R + b1 is built per stream (nxh_first_bias).
// The forward also writes a_t, the residual the adjoint needs.
//
// Adjoint.  With m_t = dMLP/da at a_t, the state cotangent lam_t = dL/ds_t
// satisfies the linear reverse-time recurrence
//   lam_t = c_t lam_{t+1} + (1 + c_t) go_t / 2,   c_t = -(m_t (1 - p) + p),
// from lam_T = g_zf, and the adjoint writes
//   G_t = lam_{t+1} + go_t / 2        (total cotangent of s_{t+1}),
//   g_vin_t = p (1 - m_t) G_t,
// and g_z0 = lam_0.  The MLP parameters' cotangent is a batched VJP with
// dL/dy = -G over every (b, t): pass 3, after pass 2, since G comes from
// pass 2's recursion.  The per-sample arithmetic is clipper_train.cuh's.
//
// Design.  Both recursions are sequential in time and independent across
// streams.  Run as one thread per stream, each stream is one thread's chain
// of ~1,200 (forward) or ~2,400 (adjoint) dependent operations a sample,
// nearly all of them the MLP's, and the training batch of 1,337 streams
// fills 11 blocks of 128 threads on 132 SMs.
//   - Forward: a group of K lanes of a warp serves one stream (nxh_lanes.cuh):
//     every lane runs the tree on the same values, the MLP's neurons are
//     split across the group, so a sample's chain falls to ~H (L + 1) FMAs
//     and shuffles, and R = 128 / K streams share a block.
//   - Adjoint: m_t depends on the stored a_t alone, not on lam.  Pass 1 gives
//     every (b, t) sample its own thread (the tangent; bound by the card's
//     f32 rate), pass 2 walks the scalar recursion, ~10 operations a sample,
//     on the pairs (m_t, go_t) that pass 1 stored.
//   - Parameters (pass 3): its bound is operations, 3,521 a sample for 2x16
//     (the forward at a_t and its backward, wdfbench/work/clipper_2x16.json
//     param_vjp), though shared memory's passes pace it on the card; it
//     reads 8 bytes a sample (a_t, G_t) and writes the 609 cotangents.
//     Every sample gets its own lane for its forward and backward, in
//     registers, and each warp sums the outer products of the samples its
//     own lanes ran: after a __syncwarp every lane adds its fixed share of
//     the cotangents over the warp's 32 records in shared memory, into sums
//     it keeps in registers for the whole walk: one 4 x 8 block of a hidden
//     layer's entries (4 x 4 at H = 4) with its bias sums, and one 1 x 4 unit
//     of the first layer or the head, each over the share of the tile's
//     samples that (H, L) leaves it, so that no lane sums a zero row.  No
//     block barrier until the walk ends, nothing per sample in device
//     memory; the block adds its warps' sums in warp order into one partial,
//     and a second launch adds the partials in a fixed order (no atomics: the
//     same bits on every call).  Float32 FMAs on the CUDA cores, no TF32.
//
// Numerics.  Exact f32 library calls only (tanhf, fmaf) and the trees'
// roundings written out: no fast-math intrinsics.  The (B,) constants p and
// log R are computed by the wrapper in double precision and rounded to f32,
// the same values the plain PyTorch versions use.  The lane forward gives
// the one-thread forward's bits (the card tests and chip_smoke.py check it);
// pass 1 and pass 2 give a one-pass walk's bits (tests/test_torch_clipper_kernels.py
// walks both on the host).
//
// Interface.  Plain C, loaded with ctypes; every launch goes on the stream
// the caller passes and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <type_traits>

#include "bulk_copy.cuh"
#include "clipper_train.cuh"
#include "nxh_lanes.cuh"
#include "nxh_mlp.cuh"
#include "tile.cuh"

namespace {

constexpr int kThreads = 128;

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// ---------------------------------------------------------------------------
// Forward (B3): K lanes a stream
// ---------------------------------------------------------------------------

// A group of K consecutive lanes serves one stream; a block of 128 threads
// holds R = 128 / K streams.  Every lane of a group runs the tree and ends
// each step with bit-identical state (nxh_lanes.cuh: every activation and
// the head have nxh_forward's bits on every lane), so the state is
// replicated, not exchanged.  v comes in and out and a go back through
// (R, 32) row tiles that the block moves as whole lines; lane `writer` of
// each group (0 but for the tests) writes them.  The weights sit in shared
// memory (lane_weight's copy); a lane holds its weight columns in registers
// where N H L + H <= 96 (NxhLaneWeights).  Launch bounds (128, 1): no register cap, so no spill.
template <int H, int K, int L>
__global__ void __launch_bounds__(kThreads, 1)
train_fwd_lanes_kernel(const float* __restrict__ vin, const float* __restrict__ z0,
                       const float* __restrict__ p1r, const float* __restrict__ log_r,
                       float* __restrict__ out, float* __restrict__ a_seq,
                       float* __restrict__ zf, int B, int T, const float* __restrict__ weights,
                       int writer) {
  constexpr int R = kThreads / K;  // streams per block
  constexpr int kW = n_lane_weights<H>(L);
  constexpr bool kRegs = (H / K) * H * L + H <= 96;
  extern __shared__ float4 lanes_smem[];  // 16-byte aligned: the lane form's word loads
  float* sw = reinterpret_cast<float*>(lanes_smem);
  for (int i = threadIdx.x; i < kW; i += blockDim.x) sw[i] = lane_weight<H>(weights, i);
  __syncthreads();
  RowTile<R>* tiles = reinterpret_cast<RowTile<R>*>(sw + ((kW + 3) & ~3));
  const int rank = threadIdx.x % K;  // the lane's place in its stream's group
  const int row = threadIdx.x / K;
  const bool lead = rank == writer;
  const int b0 = blockIdx.x * R;
  const int b = b0 + row;
  const bool live = b < B;  // rows past B run on zeros, so that every lane shuffles
  float c1[H / K];
  nxh_first_bias_lanes<H, K>(sw + H, sw + 2 * H, live ? log_r[b] : 0.f, rank, c1);
  const float p = live ? p1r[b] : 0.f;
  NxhLaneWeights<H, K, L, kRegs> lw;
  lw.load(sw + lane_hidden<H>(), sw + 3 * H, rank);
  float z = live ? z0[b] : 0.f;
  for (int t0 = 0; t0 < T; t0 += kTileCols) {
    const int tc = min(kTileCols, T - t0);
    rows_load<R>(tiles[0], vin, B, T, b0, t0, tc);
    for (int k = 0; k < tc; ++k) {
      float a;
      const float o = train_step_lanes<H, K, L>(tiles[0][row][k], p, z, a, sw, c1, rank, lw);
      __syncwarp();  // every lane of the group has read v_t
      if (lead) {
        tiles[0][row][k] = o;
        tiles[1][row][k] = a;
      }
    }
    rows_store<R>(tiles[0], out, B, T, b0, t0, tc);
    rows_store<R>(tiles[1], a_seq, B, T, b0, t0, tc);
  }
  if (live && lead) zf[b] = z;
}

// The (H, L, K) the lane kernel is built for: the families of the pretrained
// zoo and the card tests (2x4, 4x4; 2x8, 4x8; 1x16, 2x16), each at the K
// that ops/fused_clipper.py nxh_lanes can pick for its width.  Any other
// triple is an invalid value.
template <typename F>
cudaError_t by_family(int H, int L, int K, F f) {
#define CLIPPER_FAMILY(h, l, k) \
  if (H == h && L == l && K == k) return f(std::integral_constant<int, h>{}, \
                                           std::integral_constant<int, l>{}, \
                                           std::integral_constant<int, k>{});
  CLIPPER_FAMILY(4, 2, 4)
  CLIPPER_FAMILY(4, 4, 4)
  CLIPPER_FAMILY(8, 2, 8)
  CLIPPER_FAMILY(8, 4, 8)
  CLIPPER_FAMILY(16, 1, 8)
  CLIPPER_FAMILY(16, 1, 16)
  CLIPPER_FAMILY(16, 2, 8)
  CLIPPER_FAMILY(16, 2, 16)
#undef CLIPPER_FAMILY
  return cudaErrorInvalidValue;
}

// The forward's earlier form (the wrapper never calls it; the card tests
// and chip_smoke.py hold the lane form to its bits):
// one thread per stream over all T, weights in shared memory (a broadcast),
// the (B, T) streams read and written in place (a 128-byte line holds 32
// steps of one stream and stays in L1 for them).
template <int H>
__global__ void __launch_bounds__(kThreads)
train_fwd_kernel(const float* __restrict__ vin, const float* __restrict__ z0,
                 const float* __restrict__ p1r, const float* __restrict__ log_r,
                 float* __restrict__ out, float* __restrict__ a_seq,
                 float* __restrict__ zf, int B, int T,
                 const float* __restrict__ weights, int L) {
  extern __shared__ float sw[];
  stage_weights(sw, weights, n_train_weights<H>(L));

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float c1[H];
  nxh_first_bias<H>(sw + H, sw + 2 * H, log_r[b], c1);
  const float p = p1r[b];

  const size_t row = static_cast<size_t>(b) * T;
  const float* v = vin + row;
  float* o = out + row;
  float* as = a_seq + row;
  float z = z0[b];
  for (int t = 0; t < T; ++t) {
    float a;
    o[t] = train_step<H>(v[t], p, z, a, sw, c1, L);
    as[t] = a;
  }
  zf[b] = z;
}

// ---------------------------------------------------------------------------
// Adjoint (B4): pass 1, the tangents; pass 2, the recursion
// ---------------------------------------------------------------------------

constexpr int kTangentRows = kThreads / kAdjointGroup;  // steps a block covers at once (16)
constexpr int kTangentSteps = 8 * kTangentRows;         // steps of a block (128)

// Pass 1: block x takes the kAdjointGroup = 8 streams of group x / nt over
// steps 128 (x % nt) .. + 127 (nt = ceil(T / 128)); thread i takes stream
// i % 8 at steps i / 8, + 16, ..., so that a warp reads 8 rows x 16 bytes of
// a_seq and go and writes 256 contiguous bytes of the scratch.  Each thread
// builds its stream's c1 once and runs the tangent (nxh_tangent: ~2,400
// operations, 48 tanhf for 2x16) per sample; the tangent and go go to the
// scratch as one float2 (adjoint_scratch_index).  Streams past B write zeros.
template <int H>
__global__ void __launch_bounds__(kThreads)
adjoint_tangent_kernel(const float* __restrict__ a_seq, const float* __restrict__ g_out,
                       const float* __restrict__ log_r, float2* __restrict__ scratch, int B,
                       int T, const float* __restrict__ weights, int L) {
  extern __shared__ float sw[];
  stage_weights(sw, weights, n_train_weights<H>(L));
  const int nt = (T + kTangentSteps - 1) / kTangentSteps;
  const int b = (blockIdx.x / nt) * kAdjointGroup + threadIdx.x % kAdjointGroup;
  const int t0 = (blockIdx.x % nt) * kTangentSteps + threadIdx.x / kAdjointGroup;
  const int t1 = min(T, (blockIdx.x % nt + 1) * kTangentSteps);
  if (b >= B) {
    for (int t = t0; t < t1; t += kTangentRows) {
      scratch[adjoint_scratch_index(b, t, T)] = make_float2(0.f, 0.f);
    }
    return;
  }
  float c1[H];
  nxh_first_bias<H>(sw + H, sw + 2 * H, log_r[b], c1);
  const size_t row = static_cast<size_t>(b) * T;
  for (int t = t0; t < t1; t += kTangentRows) {
    scratch[adjoint_scratch_index(b, t, T)] =
        make_float2(adjoint_tangent<H>(a_seq[row + t], sw, c1, L), g_out[row + t]);
  }
}

constexpr int kSlab = kTileCols;  // steps per stage of pass 2's ring: one output tile
constexpr int kStages = 16;       // stages in the ring, kStages - 1 slabs in flight
constexpr int kSlabPairs = kSlab * kAdjointGroup;  // float2 of one stage (2 KB)

// Pass 2: one warp per group of 8 streams (a block each, so that the groups
// spread over the SMs: 168 blocks at B = 1,337), walking T - 1 .. 0; lanes
// 0 .. 7 each own a stream.  Its chain is ~10 operations a step; what paces
// it is how fast the SM pulls its group's 64 bytes a step.  So the scratch
// streams into a ring of kStages slabs of 32 steps in shared memory by bulk
// copies (the Tensor Memory Accelerator: lane 0 issues a whole slab,
// contiguous in the scratch, and an mbarrier counts its bytes), 15 slabs in
// flight; G and g_vin go out through (8, 32) tiles as whole lines (16-byte
// stores where T allows).  As in the generated adjoint's pass 2
// (ops/circuit_codegen.py, B8).
__global__ void __launch_bounds__(32, 1)
adjoint_recursion_kernel(const float2* __restrict__ scratch, const float* __restrict__ g_zf,
                         const float* __restrict__ p1r, float* __restrict__ g_vin,
                         float* __restrict__ G, float* __restrict__ g_z0, int B, int T) {
  extern __shared__ float4 smem4[];
  __shared__ unsigned long long full[kStages];  // one mbarrier a stage
  float2* ring = reinterpret_cast<float2*>(smem4);
  float (*otile)[kAdjointGroup][kTileCols + 1] =
      reinterpret_cast<float (*)[kAdjointGroup][kTileCols + 1]>(ring + kStages * kSlabPairs);
  const int lane = threadIdx.x;
  const int b = blockIdx.x * kAdjointGroup + lane;
  const bool live = lane < kAdjointGroup && b < B;
  const float2* src = scratch + static_cast<size_t>(blockIdx.x) * T * kAdjointGroup;
  float lam = live ? g_zf[b] : 0.f;
  const float p = live ? p1r[b] : 0.f;
  if (lane == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  __syncwarp();
  const int n_slabs = (T + kSlab - 1) / kSlab;
  // the u-th slab walked (slab n_slabs - 1 - u) into stage u % kStages
  auto issue = [&](int u) {
    if (lane == 0 && u < n_slabs) {
      const int j = n_slabs - 1 - u;
      const int n = min(kSlab, T - j * kSlab);
      const unsigned bytes = static_cast<unsigned>(n) * kAdjointGroup * sizeof(float2);
      mbar_expect_tx(&full[u % kStages], bytes);
      bulk_copy(ring + (u % kStages) * kSlabPairs, src + static_cast<size_t>(j) * kSlabPairs,
                bytes, &full[u % kStages]);
    }
  };
  const bool vec_out = T % 4 == 0;  // 16-byte stores of whole tiles
  for (int u = 0; u < kStages - 1; ++u) issue(u);
  for (int u = 0; u < n_slabs; ++u) {
    issue(u + kStages - 1);  // into the stage that slab u - 1 left
    mbar_wait(&full[u % kStages], (u / kStages) & 1);  // slab u has landed
    const int j = n_slabs - 1 - u;
    const int n = min(kSlab, T - j * kSlab);
    if (lane < kAdjointGroup) {
      const float2* mine = ring + (u % kStages) * kSlabPairs + lane;
      for (int k = n - 1; k >= 0; --k) {
        const float2 e = mine[k * kAdjointGroup];  // (m_t, go_t)
        float Gt;
        otile[1][lane][k] = adjoint_update(e.x, e.y, p, lam, Gt);
        otile[0][lane][k] = Gt;
      }
    }
    __syncwarp();
    const int t0 = j * kSlab;
    if (vec_out && n == kTileCols) {
      for (int i = lane; i < kAdjointGroup * kTileCols / 4; i += 32) {
        const int rr = i / (kTileCols / 4), cc = 4 * (i % (kTileCols / 4));
        const int bb = blockIdx.x * kAdjointGroup + rr;
        if (bb < B) {
          const size_t at = static_cast<size_t>(bb) * T + t0 + cc;
          *reinterpret_cast<float4*>(G + at) = make_float4(
              otile[0][rr][cc], otile[0][rr][cc + 1], otile[0][rr][cc + 2], otile[0][rr][cc + 3]);
          *reinterpret_cast<float4*>(g_vin + at) = make_float4(
              otile[1][rr][cc], otile[1][rr][cc + 1], otile[1][rr][cc + 2], otile[1][rr][cc + 3]);
        }
      }
    } else {
      for (int i = lane; i < kAdjointGroup * kTileCols; i += 32) {
        const int rr = i / kTileCols, cc = i % kTileCols;
        const int bb = blockIdx.x * kAdjointGroup + rr;
        if (bb < B && cc < n) {
          const size_t at = static_cast<size_t>(bb) * T + t0 + cc;
          G[at] = otile[0][rr][cc];
          g_vin[at] = otile[1][rr][cc];
        }
      }
    }
    __syncwarp();  // stage u % kStages and the tiles are free again
  }
  if (live) g_z0[b] = lam;
}

// ---------------------------------------------------------------------------
// Pass 3 (B4): the MLP parameters' cotangents
// ---------------------------------------------------------------------------

constexpr int kParamThreads = 128;  // threads of a pass-3 block at most: 4 warps

// Pass 3: warp w of the grid's W walks the flat (B, T) samples 32 at a time,
// tiles w, w + W, ..., one sample a lane.  Each lane runs its sample
// (param_sample: the forward at a and the backward from dy = -G, ~3,500
// operations for 2x16, all in registers) and leaves it in its record in the
// warp's own slice of shared memory; after a __syncwarp each lane adds the
// outer products of its block and its unit (param_job), each over its share
// of the tile's samples, to sums it holds in registers for the whole walk: a
// tile's sum in sample order first, then added to the running sum.  No block
// barrier in the walk and no sum in shared memory.  At the end, one barrier:
// the block adds its warps' sums, and a job's shares, in a fixed order and
// writes its one partial (n_param_leaves floats; group blockIdx.y writes the
// leaves of its blocks).  Nothing per sample goes to device memory.  The
// walk is bound by shared memory's bandwidth (a 16-byte load of 32 lanes that
// read different words takes four passes), not by residency, so the launch
// bounds leave the registers to the sums and the sample (3 blocks an SM).
template <int H>
__global__ void __launch_bounds__(kParamThreads, 3)
param_cotangent_kernel(const float* __restrict__ a_seq, const float* __restrict__ G,
                       const float* __restrict__ log_r, float* __restrict__ partials,
                       long long N, long long tiles, int T, const float* __restrict__ weights,
                       int L) {
  using Block = ParamSums<ParamBlock<H>::M, ParamBlock<H>::N>;
  constexpr int kBlock = Block::kEntries, kUnit = ParamUnitSums::kEntries;
  extern __shared__ float4 param_smem4[];
  const int n_w = n_lane_weights<H>(L);
  float* sw = reinterpret_cast<float*>(param_smem4);
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) sw[i] = lane_weight<H>(weights, i);
  const int stride = param_record_floats<H>(L);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  float* slice = reinterpret_cast<float*>(param_smem4 + (n_w + 3) / 4) +
                 warp * param_slice_floats<H>(L);
  __syncthreads();
  // the block's and the unit's factors in a record (their leaves are found
  // again at the end, so that they take no registers in the walk)
  const ParamJob bj0 = param_job<H>(L, blockIdx.y, lane, 0);
  const ParamJob uj0 = param_job<H>(L, blockIdx.y, lane, 1);
  const int bx = bj0.x, by = bj0.y, ux = uj0.x, uy = uj0.y;
  // the lane's shares of a tile: the block's samples b0 .. b0 + per - 1 (per
  // = 32 / S), the unit's u0 .. u0 + H - 1
  const int per = 32 / param_plan<H>(L).S, b0 = lane / per * per, u0 = lane / H * H;
  Block block = {};
  ParamUnitSums unit = {};
  // this lane's sample (b, t) of tile x, stepped on by W 32 samples a tile
  // (32-bit arithmetic: a 64-bit division is a call, and its saved
  // registers spill)
  const int gw = blockIdx.x * warps + warp, n_warps = gridDim.x * warps;
  const int step = n_warps * 32, n_first = gw * 32 + lane;
  int b = n_first / T, t = n_first % T;
  const int db = step / T, dt = step % T;
  for (long long x = gw; x < tiles; x += n_warps) {
    const long long n0 = x * 32;
    const int valid = static_cast<int>(min(32LL, N - n0));
    if (lane < valid) {
      const float a = a_seq[n0 + lane], lr = log_r[b], dy = -G[n0 + lane];
      ParamRecord<H> rec{slice + lane * stride};
      param_sample<H>(a, lr, dy, sw, L, rec);
      reinterpret_cast<float4*>(rec.rec + (2 * L + 2) * H)[0] = make_float4(a, lr, 1.f, dy);
    }
    b += db;
    t += dt;
    if (t >= T) {
      t -= T;
      ++b;
    }
    __syncwarp();  // the tile's records are written
    param_accumulate(slice, stride, b0, min(b0 + per, valid), bx, by, block);
    param_accumulate(slice, stride, u0, min(u0 + H, valid), ux, uy, unit);
    __syncwarp();  // every lane has read them
  }
  // each warp leaves its sums in its slice, entry e of a lane at e 32 + lane
  // (its block's, then its unit's); the first warp adds them in warp order,
  // a job's shares in lane order within each warp, and writes the partial
  float* sums = slice + param_slice_floats<H>(L) - 32 * (kBlock + kUnit);
#pragma unroll
  for (int e = 0; e < kBlock; ++e) sums[e * 32 + lane] = param_entry(block, e);
#pragma unroll
  for (int e = 0; e < kUnit; ++e) sums[(kBlock + e) * 32 + lane] = param_entry(unit, e);
  __syncthreads();
  if (warp > 0) return;
  float* out = partials + static_cast<size_t>(blockIdx.x) * n_param_leaves<H>(L);
  auto add = [&](int e, int shares, int apart) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) {
      for (int p = 0; p < shares; ++p) {
        s += sums[w * param_slice_floats<H>(L) + e * 32 + lane + p * apart];
      }
    }
    return s;
  };
  const ParamJob bj = param_job<H>(L, blockIdx.y, lane, 0);
#pragma unroll
  for (int e = 0; e < kBlock; ++e) {
    const int leaf = param_leaf<H, ParamBlock<H>::M, ParamBlock<H>::N>(bj, e);
    if (leaf >= 0) out[leaf] = add(e, 32 / per, per);
  }
  const ParamJob uj = param_job<H>(L, blockIdx.y, lane, 1);
#pragma unroll
  for (int e = 0; e < kUnit; ++e) {
    const int leaf = param_leaf<H, 1, 4>(uj, e);
    if (leaf >= 0) out[leaf] = add(kBlock + e, param_unit_shares(H), H);
  }
}

// The blocks' partials summed in block order, one thread a cotangent: the
// same bits on every call (no atomics).
__global__ void __launch_bounds__(kParamThreads)
param_sum_kernel(const float* __restrict__ partials, int blocks, int n,
                 float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < blocks; ++c) s += partials[static_cast<size_t>(c) * n + i];
  out[i] = s;
}

// `blocks` blocks of kThreads with `smem` bytes of shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int blocks, size_t smem, cudaStream_t stream, Args... args) {
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Calls f(std::integral_constant<int, H>) for the widths the one-thread
// kernels and the adjoint's three passes are compiled for; any other H is an
// invalid value.
template <typename F>
cudaError_t by_width(int H, F f) {
  switch (H) {
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

// Pass 3's block at (H, L): the most warps (4, 2 or 1) whose shared memory,
// the weights (lane_weight's copy) and a slice a warp (param_slice_floats),
// fits a block of this card; lets the kernel take it.
template <int W>
cudaError_t param_config(int L, int& warps, size_t& smem) {
  int dev, most;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  for (warps = kParamThreads / 32; warps > 0; warps /= 2) {
    smem = 16 * static_cast<size_t>((n_lane_weights<W>(L) + 3) / 4) +
           sizeof(float) * warps * static_cast<size_t>(param_slice_floats<W>(L));
    if (smem <= static_cast<size_t>(most)) {
      return allow_smem(reinterpret_cast<const void*>(param_cotangent_kernel<W>), smem);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// B3: the forward on K lanes a stream (K one of the family's; writer the
// lane of a group that writes).
int clipper_train_fwd_launch(const float* vin, const float* z0, const float* p1r,
                             const float* log_r, float* out, float* a_seq, float* zf, int B,
                             int T, const float* weights, int H, int L, int K, int writer,
                             void* stream) {
  if (writer < 0 || writer >= K) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_family(H, L, K, [&](auto h, auto l, auto k) {
    constexpr int W = decltype(h)::value, NL = decltype(l)::value, NK = decltype(k)::value;
    constexpr int R = kThreads / NK;
    const size_t smem = sizeof(float) * ((n_lane_weights<W>(NL) + 3) & ~3) +
                        2 * sizeof(RowTile<R>);
    return launch(train_fwd_lanes_kernel<W, NK, NL>, (B + R - 1) / R, smem, s, vin, z0, p1r,
                  log_r, out, a_seq, zf, B, T, weights, writer);
  }));
}

// The forward's earlier form, one thread a stream (reference only).
int clipper_train_fwd_onethread_launch(const float* vin, const float* z0, const float* p1r,
                                       const float* log_r, float* out, float* a_seq, float* zf,
                                       int B, int T, const float* weights, int H, int L,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_width(H, [&](auto h) {
    constexpr int W = decltype(h)::value;
    return launch(train_fwd_kernel<W>, (B + kThreads - 1) / kThreads,
                  sizeof(float) * static_cast<size_t>(n_train_weights<W>(L)), s, vin, z0, p1r,
                  log_r, out, a_seq, zf, B, T, weights, L);
  }));
}

// B4 pass 1: the pairs (m, go) of every sample into the scratch of
// 2 ceil(B / 8) 8 T floats (adjoint_scratch_index).
int clipper_tangent_launch(const float* a_seq, const float* g_out, const float* log_r,
                           float* scratch, int B, int T, const float* weights, int H, int L,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (B + kAdjointGroup - 1) / kAdjointGroup;
  const int nt = (T + kTangentSteps - 1) / kTangentSteps;
  return static_cast<int>(by_width(H, [&](auto h) {
    constexpr int W = decltype(h)::value;
    return launch(adjoint_tangent_kernel<W>, groups * nt,
                  sizeof(float) * static_cast<size_t>(n_train_weights<W>(L)), s, a_seq, g_out,
                  log_r, reinterpret_cast<float2*>(scratch), B, T, weights, L);
  }));
}

// B4 pass 2: the recursion from lam_T = g_zf over pass 1's scratch; writes
// g_vin and G (B, T) and g_z0 (B,).
int clipper_recursion_launch(const float* scratch, const float* g_zf, const float* p1r,
                             float* g_vin, float* G, float* g_z0, int B, int T, void* stream) {
  const size_t smem = sizeof(float2) * kStages * kSlabPairs +
                      sizeof(float) * 2 * kAdjointGroup * (kTileCols + 1);
  const cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(adjoint_recursion_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  adjoint_recursion_kernel<<<(B + kAdjointGroup - 1) / kAdjointGroup, 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(scratch), g_zf, p1r, g_vin, G, g_z0, B, T);
  return static_cast<int>(cudaGetLastError());
}

// B4 pass 3: the blocks pass 3 runs at most for (H, L), as many as this card
// holds resident at once; the caller's partials hold that many rows.
int clipper_param_ctas(int H, int L, int* ctas) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_width(H, [&](auto h) {
    constexpr int W = decltype(h)::value;
    int warps, per_sm = 0, dev, sms;
    size_t smem;
    cudaError_t e = param_config<W>(L, warps, smem);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, param_cotangent_kernel<W>,
                                                        32 * warps, smem);
    }
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    *ctas = per_sm * sms;
    return cudaSuccess;
  }));
}

// B4 pass 3: the cotangents of the MLP's parameters (n_param_leaves floats
// into out, mlp_leaves order) from a_seq, G (B, T) and log R (B,), through
// partials of max_ctas rows of n_param_leaves floats (clipper_param_ctas).
int clipper_param_launch(const float* a_seq, const float* G, const float* log_r,
                         float* partials, int max_ctas, float* out, int B, int T,
                         const float* weights, int H, int L, void* stream) {
  if (B <= 0 || T <= 0 || L < 1 || max_ctas < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_width(H, [&](auto h) {
    constexpr int W = decltype(h)::value;
    int warps;
    size_t smem;
    cudaError_t e = param_config<W>(L, warps, smem);
    if (e != cudaSuccess) return e;
    const long long N = static_cast<long long>(B) * T;
    const long long tiles = (N + 31) / 32;
    const long long want = (tiles + warps - 1) / warps;
    const int blocks = want < max_ctas ? static_cast<int>(want) : max_ctas;
    const dim3 grid(blocks, param_plan<W>(L).G);
    param_cotangent_kernel<W><<<grid, 32 * warps, smem, s>>>(a_seq, G, log_r, partials, N, tiles,
                                                             T, weights, L);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int n = n_param_leaves<W>(L);
    param_sum_kernel<<<(n + kParamThreads - 1) / kParamThreads, kParamThreads, 0, s>>>(
        partials, blocks, n, out);
    return cudaGetLastError();
  }));
}

}  // extern "C"
