"""The clipper's training kernels' per-sample functions, compiled on the CPU.

``csrc/clipper_train.cuh`` holds what each kernel of the clipper's in-circuit
training runs per sample: the forward step with the whole NxH root on one
thread (``train_step``, the one-thread kernel) and on a group of K lanes
(``train_step_lanes`` on the lane kernel's copy of the weights,
``lane_weight``: the lane kernel B3), the tangent of pass 1
(``adjoint_tangent``), the reverse step of pass 2 (``adjoint_update``) and
the scratch layout between the passes (``adjoint_scratch_index``).  The host
C++ compiler builds them here with the
stand-in ``cuda_runtime.h`` of ``tests/test_torch_codegen.py`` (a group of K
lanes is K host threads, ``__shfl_sync`` through a shared array), and a
ctypes harness walks them as the kernels do.  For every NxH family the lane
kernel is built for, the lane step at every K that divides H gives the
one-thread step's bits on every lane; pass 1 into the scratch and pass 2
walking it back give the bits of a one-pass walk with the same steps; the
one-thread forward is within the suite's 2e-5 of
``fused_clipper_neural_train_fwd_plain`` and the
one-pass adjoint within 2e-5 of scale of ``clipper_adjoint_plain``.  Pass 3
(the MLP parameters' cotangents): one sample's forward and backward
(``param_sample``) at every sample into its record, summed a tile of 32
samples at a time by every lane's block and unit, each over its share of the
tile (``param_plan``, ``param_job``, ``param_accumulate``, ``param_leaf``), as
one warp of the kernel sums them, within 2e-5 of scale of autograd of the
plain MLP at H = 4, 8, 16 and L = 1, 2 and at four L outside the families
(two of them in two groups); the jobs' entries on every leaf once, and each
family's plan.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from diffwdf_tpu_torch.ops import _build
from diffwdf_tpu_torch.ops import clipper_train as ct
from diffwdf_tpu_torch.ops import fused_clipper as fc
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot
from test_torch_codegen import CUDA_RUNTIME_STANDIN, LANE_GROUP_HARNESS, LANE_SHUFFLE_STANDIN

FS, CAP = 48000.0, 4.7e-9
#: (n_layers, width) of the NxH families the lane kernel is built for
FAMILIES = [(1, 16), (2, 4), (2, 8), (2, 16), (4, 4), (4, 8)]

HARNESS = """
#include <algorithm>
#include <vector>

#include "clipper_train.cuh"

template <int H>
static void fwd_one_thread(const float* vin, const float* z0, const float* p1r,
                           const float* log_r, float* out, float* as, float* zf, int B, int T,
                           const float* w, int L) {
  for (int b = 0; b < B; ++b) {
    float c1[H];
    nxh_first_bias<H>(w + H, w + 2 * H, log_r[b], c1);
    float z = z0[b];
    for (long t = 0; t < T; ++t) {
      float a;
      out[b * T + t] = train_step<H>(vin[b * T + t], p1r[b], z, a, w, c1, L);
      as[b * T + t] = a;
    }
    zf[b] = z;
  }
}

// out and as (K, B, T), zf (K, B): lane by lane
template <int H, int K, int L>
static void fwd_lanes(const float* vin, const float* z0, const float* p1r, const float* log_r,
                      float* out, float* as, float* zf, int B, int T, const float* w) {
  constexpr bool kRegs = (H / K) * H * L + H <= 96;
  std::vector<float> copy(n_lane_weights<H>(L));  // the lane kernel's shared-memory copy
  for (int i = 0; i < n_lane_weights<H>(L); ++i) copy[i] = lane_weight<H>(w, i);
  const float* sw = copy.data();
  for (int b = 0; b < B; ++b) {
    standin_run_group(K, [&](int rank) {
      float c1[H / K];
      nxh_first_bias_lanes<H, K>(sw + H, sw + 2 * H, log_r[b], rank, c1);
      NxhLaneWeights<H, K, L, kRegs> lw;
      lw.load(sw + lane_hidden<H>(), sw + 3 * H, rank);
      float z = z0[b];
      for (long t = 0; t < T; ++t) {
        float a;
        const long at = (static_cast<long>(rank) * B + b) * T + t;
        out[at] = train_step_lanes<H, K, L>(vin[b * T + t], p1r[b], z, a, sw, c1, rank, lw);
        as[at] = a;
      }
      zf[rank * B + b] = z;
    });
  }
}

// pass 1 into the scratch (every sample of the whole groups), then pass 2
template <int H>
static void adjoint_two_pass(const float* a_seq, const float* g_out, const float* g_zf,
                             const float* p1r, const float* log_r, float* g_vin, float* G,
                             float* g_z0, float* scratch, int B, int T, const float* w, int L) {
  float2* pairs = reinterpret_cast<float2*>(scratch);
  const int padded = (B + kAdjointGroup - 1) / kAdjointGroup * kAdjointGroup;
  for (int b = 0; b < padded; ++b) {
    float c1[H];
    nxh_first_bias<H>(w + H, w + 2 * H, b < B ? log_r[b] : 0.f, c1);
    for (int t = 0; t < T; ++t) {
      float2& e = pairs[adjoint_scratch_index(b, t, T)];
      e.x = b < B ? adjoint_tangent<H>(a_seq[static_cast<long>(b) * T + t], w, c1, L) : 0.f;
      e.y = b < B ? g_out[static_cast<long>(b) * T + t] : 0.f;
    }
  }
  for (int b = 0; b < B; ++b) {
    float lam = g_zf[b];
    for (int t = T - 1; t >= 0; --t) {
      const float2 e = pairs[adjoint_scratch_index(b, t, T)];
      float Gt;
      g_vin[static_cast<long>(b) * T + t] = adjoint_update(e.x, e.y, p1r[b], lam, Gt);
      G[static_cast<long>(b) * T + t] = Gt;
    }
    g_z0[b] = lam;
  }
}

template <int H>
static void adjoint_one_pass(const float* a_seq, const float* g_out, const float* g_zf,
                             const float* p1r, const float* log_r, float* g_vin, float* G,
                             float* g_z0, int B, int T, const float* w, int L) {
  for (int b = 0; b < B; ++b) {
    float c1[H];
    nxh_first_bias<H>(w + H, w + 2 * H, log_r[b], c1);
    float lam = g_zf[b];
    for (int t = T - 1; t >= 0; --t) {
      const long at = static_cast<long>(b) * T + t;
      float Gt;
      g_vin[at] = adjoint_update(adjoint_tangent<H>(a_seq[at], w, c1, L), g_out[at], p1r[b], lam,
                                 Gt);
      G[at] = Gt;
    }
    g_z0[b] = lam;
  }
}

// pass 3 on the host as one warp of the kernel walks the samples: a tile's
// 32 samples into their records (param_sample, ParamRecord, the word [a,
// log R, 1, dy]), then each lane's block and unit (param_job) in every
// group, each over the lane's share of the tile, summed into the lane's sums
// (param_accumulate); at the end each entry of a keeping lane written to its
// leaf (param_leaf), the sum of its shares' entries in lane order
template <int H>
static void param_cotangents(const float* a, const float* log_r, const float* G, int B, int T,
                             const float* w, int L, float* out) {
  constexpr int M = ParamBlock<H>::M, N = ParamBlock<H>::N;
  std::vector<float> copy(n_lane_weights<H>(L));  // the kernel's shared-memory copy
  for (int i = 0; i < n_lane_weights<H>(L); ++i) copy[i] = lane_weight<H>(w, i);
  const ParamPlan plan = param_plan<H>(L);
  const int stride = param_record_floats<H>(L), n = B * T, per = 32 / plan.S;
  std::vector<float> recs(32 * stride);
  std::vector<ParamSums<M, N>> blocks(plan.G * 32, ParamSums<M, N>{});
  std::vector<ParamUnitSums> units(plan.G * 32, ParamUnitSums{});
  for (int n0 = 0; n0 < n; n0 += 32) {
    const int valid = std::min(32, n - n0);
    for (int s = 0; s < valid; ++s) {
      ParamRecord<H> rec{recs.data() + s * stride};
      param_sample<H>(a[n0 + s], log_r[(n0 + s) / T], -G[n0 + s], copy.data(), L, rec);
      *reinterpret_cast<float4*>(rec.rec + (2 * L + 2) * H) =
          float4{a[n0 + s], log_r[(n0 + s) / T], 1.f, -G[n0 + s]};
    }
    for (int g = 0; g < plan.G; ++g) {
      for (int lane = 0; lane < 32; ++lane) {
        const ParamJob bj = param_job<H>(L, g, lane, 0), uj = param_job<H>(L, g, lane, 1);
        const int b0 = lane / per * per, u0 = lane / H * H;
        param_accumulate(recs.data(), stride, b0, std::min(b0 + per, valid), bj.x, bj.y,
                         blocks[g * 32 + lane]);
        param_accumulate(recs.data(), stride, u0, std::min(u0 + H, valid), uj.x, uj.y,
                         units[g * 32 + lane]);
      }
    }
  }
  for (int g = 0; g < plan.G; ++g) {
    for (int lane = 0; lane < 32; ++lane) {
      const ParamJob bj = param_job<H>(L, g, lane, 0), uj = param_job<H>(L, g, lane, 1);
      for (int e = 0; e < ParamSums<M, N>::kEntries; ++e) {
        const int leaf = param_leaf<H, M, N>(bj, e);
        if (leaf < 0) continue;
        float sum = 0.f;
        for (int p = 0; p < plan.S; ++p) sum += param_entry(blocks[g * 32 + lane + p * per], e);
        out[leaf] = sum;
      }
      for (int e = 0; e < ParamUnitSums::kEntries; ++e) {
        const int leaf = param_leaf<H, 1, 4>(uj, e);
        if (leaf < 0) continue;
        float sum = 0.f;
        for (int p = 0; p < param_unit_shares(H); ++p) {
          sum += param_entry(units[g * 32 + lane + p * H], e);
        }
        out[leaf] = sum;
      }
    }
  }
}

// the leaf of every entry of every lane's block and unit in every group (-1
// for none), the plan (S, G) into plan_out; returns the count of entries
template <int H>
static int param_leaves(int L, int* leaf, int* plan_out) {
  constexpr int M = ParamBlock<H>::M, N = ParamBlock<H>::N;
  const ParamPlan plan = param_plan<H>(L);
  plan_out[0] = plan.S;
  plan_out[1] = plan.G;
  int n = 0;
  for (int g = 0; g < plan.G; ++g) {
    for (int lane = 0; lane < 32; ++lane) {
      const ParamJob bj = param_job<H>(L, g, lane, 0), uj = param_job<H>(L, g, lane, 1);
      for (int e = 0; e < ParamSums<M, N>::kEntries; ++e) leaf[n++] = param_leaf<H, M, N>(bj, e);
      for (int e = 0; e < ParamUnitSums::kEntries; ++e) leaf[n++] = param_leaf<H, 1, 4>(uj, e);
    }
  }
  return n;
}

#define BY_WIDTH(call) \\
  switch (H) {         \\
    case 4: call(4); break;  \\
    case 8: call(8); break;  \\
    case 16: call(16); break; \\
  }

extern "C" {

void host_fwd_one_thread(int H, const float* vin, const float* z0, const float* p1r,
                         const float* log_r, float* out, float* as, float* zf, int B, int T,
                         const float* w, int L) {
#define CALL(h) fwd_one_thread<h>(vin, z0, p1r, log_r, out, as, zf, B, T, w, L)
  BY_WIDTH(CALL)
#undef CALL
}

void host_fwd_lanes(int H, int L, int K, const float* vin, const float* z0, const float* p1r,
                    const float* log_r, float* out, float* as, float* zf, int B, int T,
                    const float* w) {
#define LANES(h, l, k) \\
  if (H == h && L == l && K == k) fwd_lanes<h, k, l>(vin, z0, p1r, log_r, out, as, zf, B, T, w);
  LANES(4, 2, 4) LANES(4, 4, 4)
  LANES(8, 2, 4) LANES(8, 2, 8) LANES(8, 4, 4) LANES(8, 4, 8)
  LANES(16, 1, 4) LANES(16, 1, 8) LANES(16, 1, 16)
  LANES(16, 2, 4) LANES(16, 2, 8) LANES(16, 2, 16)
#undef LANES
}

void host_adjoint_two_pass(int H, const float* a_seq, const float* g_out, const float* g_zf,
                           const float* p1r, const float* log_r, float* g_vin, float* G,
                           float* g_z0, float* scratch, int B, int T, const float* w, int L) {
#define CALL(h) adjoint_two_pass<h>(a_seq, g_out, g_zf, p1r, log_r, g_vin, G, g_z0, scratch, B, \\
                                    T, w, L)
  BY_WIDTH(CALL)
#undef CALL
}

void host_adjoint_one_pass(int H, const float* a_seq, const float* g_out, const float* g_zf,
                           const float* p1r, const float* log_r, float* g_vin, float* G,
                           float* g_z0, int B, int T, const float* w, int L) {
#define CALL(h) adjoint_one_pass<h>(a_seq, g_out, g_zf, p1r, log_r, g_vin, G, g_z0, B, T, w, L)
  BY_WIDTH(CALL)
#undef CALL
}

void host_param_cotangents(int H, const float* a, const float* log_r, const float* G, int B,
                           int T, const float* w, int L, float* out) {
#define CALL(h) param_cotangents<h>(a, log_r, G, B, T, w, L, out)
  BY_WIDTH(CALL)
#undef CALL
}

// the leaf of every entry of the plan's jobs (param_leaves), the plan (S, G)
// into plan_out; returns the count of entries
int host_param_leaves(int H, int L, int* leaf, int* plan_out) {
  switch (H) {
    case 4: return param_leaves<4>(L, leaf, plan_out);
    case 8: return param_leaves<8>(L, leaf, plan_out);
    case 16: return param_leaves<16>(L, leaf, plan_out);
  }
  return -1;
}

}  // extern "C"
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The harness built once with the host compiler and the lane stand-in."""
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    inc = tmp_path_factory.mktemp("standin_clipper")
    (inc / "cuda_runtime.h").write_text(CUDA_RUNTIME_STANDIN + LANE_SHUFFLE_STANDIN)
    src, so = inc / "clipper_kernels.cpp", inc / "clipper_kernels.so"
    src.write_text(LANE_GROUP_HARNESS + HARNESS)
    proc = subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-x", "c++",
                           f"-I{inc}", f"-I{_build.CSRC_DIR}", "-o", str(so), str(src)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    out = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    out.host_fwd_one_thread.argtypes = [i] + [vp] * 7 + [i, i, vp, i]
    out.host_fwd_lanes.argtypes = [i, i, i] + [vp] * 7 + [i, i, vp]
    out.host_adjoint_two_pass.argtypes = [i] + [vp] * 9 + [i, i, vp, i]
    out.host_adjoint_one_pass.argtypes = [i] + [vp] * 8 + [i, i, vp, i]
    out.host_param_cotangents.argtypes = [i] + [vp] * 3 + [i, i, vp, i, vp]
    out.host_param_leaves.argtypes = [i, i, vp, vp]
    return out


def _ptrs(*xs):
    return [x.data_ptr() for x in xs]


def _family(n_layers, width, b, t, seed):
    """A random-init NxH root, its weight buffer and per-row constants, and
    seeded streams: (mlp, H, L, w, p1r, log_r, r_rows, vin, z0)."""
    mlp = NeuralDiodeRoot(name="dp", n_layers=n_layers, layer_size=width).init_params(
        "cpu", torch.Generator().manual_seed(seed))["dp"]
    H, L, w = fc.train_weights(mlp, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    r_rows = torch.from_numpy(np.geomspace(10e3, 99e3, b).astype(np.float32))
    p1r, log_r = fc.row_constants(r_rows, CAP, FS)
    vin = torch.from_numpy((2.0 * rng.standard_normal((b, t))).astype(np.float32))
    z0 = torch.from_numpy(rng.uniform(-0.5, 0.5, b).astype(np.float32))
    return mlp, H, L, w, p1r, log_r, r_rows, vin, z0


@pytest.mark.parametrize("n_layers,width", FAMILIES)
def test_host_lane_step_matches_one_thread_step(lib, n_layers, width):
    """The training forward's lane step (train_step_lanes: the clipper's
    tree on every lane, the root split over K host threads) at every K that
    divides H: every lane ends every step with the one-thread step's bits
    for out, a and the final state; the one-thread step is within 2e-5 of
    the plain version."""
    b, t = 3, 64
    mlp, H, L, w, p1r, log_r, r_rows, vin, z0 = _family(n_layers, width, b, t, seed=width + n_layers)
    one = [torch.empty(b, t), torch.empty(b, t), torch.empty(b)]
    lib.host_fwd_one_thread(H, *_ptrs(vin, z0, p1r, log_r, *one), b, t, w.data_ptr(), L)
    want = fc.fused_clipper_neural_train_fwd_plain(vin, z0, mlp, r_rows, CAP, fs=FS)
    for got, ref in zip(one, (want[0], want[2], want[1])):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=0)
    ks = [k for k in fc.LANES if H % k == 0]
    assert set(fc.nxh_lane_counts(H)) <= set(ks)  # every K the kernel is built for
    for K in ks:
        out, a_seq, zf = torch.empty(K, b, t), torch.empty(K, b, t), torch.empty(K, b)
        lib.host_fwd_lanes(H, L, K, *_ptrs(vin, z0, p1r, log_r, out, a_seq, zf), b, t,
                           w.data_ptr())
        for rank in range(K):
            assert torch.equal(out[rank], one[0]), (K, rank)
            assert torch.equal(a_seq[rank], one[1]), (K, rank)
            assert torch.equal(zf[rank], one[2]), (K, rank)


@pytest.mark.parametrize("n_layers,width", FAMILIES)
def test_host_two_pass_adjoint_equals_one_pass(lib, n_layers, width):
    """The adjoint as the card runs it, pass 1 (adjoint_tangent at every
    sample, into the scratch layout of adjoint_scratch_index with a ragged
    last group) and pass 2 (adjoint_update walking it back), gives the
    one-pass walk's bits for g_vin, G and g_z0; the one-pass walk is within
    2e-5 of scale of clipper_adjoint_plain."""
    b, t = 11, 96  # 11 streams: a whole group of 8 and a ragged one
    mlp, H, L, w, p1r, log_r, r_rows, vin, z0 = _family(n_layers, width, b, t, seed=width + 7)
    _, _, a_seq = fc.fused_clipper_neural_train_fwd_plain(vin, z0, mlp, r_rows, CAP, fs=FS)
    rng = np.random.default_rng(n_layers * 100 + width)
    g_out = torch.from_numpy(rng.standard_normal((b, t)).astype(np.float32))
    g_zf = torch.from_numpy(rng.standard_normal(b).astype(np.float32))
    one = [torch.empty(b, t), torch.empty(b, t), torch.empty(b)]
    lib.host_adjoint_one_pass(H, *_ptrs(a_seq, g_out, g_zf, p1r, log_r, *one), b, t,
                              w.data_ptr(), L)
    two = [torch.empty(b, t), torch.empty(b, t), torch.empty(b)]
    scratch = torch.full((ct.adjoint_scratch_floats(b, t),), float("nan"))
    lib.host_adjoint_two_pass(H, *_ptrs(a_seq, g_out, g_zf, p1r, log_r, *two, scratch), b, t,
                              w.data_ptr(), L)
    assert not bool(torch.isnan(scratch).any())  # pass 1 filled the whole groups
    for x, y in zip(two, one):
        assert torch.equal(x, y)
    want = ct.clipper_adjoint_plain(a_seq, g_out, g_zf, r_rows, mlp, CAP, fs=FS)
    for got, ref in zip(one, want):
        assert bool(torch.isfinite(got).all())
        scale = max(float(ref.abs().max()), 1e-8)
        np.testing.assert_allclose((got / scale).numpy(), (ref / scale).numpy(), atol=2e-5,
                                   rtol=0)


def test_train_lanes_follow_the_lane_table():
    """The training forward takes, like the generated forward, the largest K
    of LANES dividing H at most the batch's target (K = 16 up to B = 2,048,
    else 8, for H = 16); the lane kernel is built for exactly the (H, L, K)
    of TRAIN_FAMILIES at those K (csrc/clipper_train.cu by_family)."""
    assert [fc.nxh_lanes(16, n) for n in (1, 335, 1337, 2048, 2049, 8192)] == [16] * 4 + [8] * 2
    assert [fc.nxh_lanes(h, n) for h in (4, 8) for n in (1, 8192)] == [4, 4, 8, 8]
    assert {h: fc.nxh_lane_counts(h) for h in (4, 8, 16)} == {4: (4,), 8: (8,), 16: (8, 16)}
    assert sorted((width, n) for n, width in FAMILIES) == sorted(fc.TRAIN_FAMILIES)
    source = (_build.CSRC_DIR / "clipper_train.cu").read_text()
    built = {tuple(map(int, m)) for m in re.findall(r"CLIPPER_FAMILY\((\d+), (\d+), (\d+)\)\n",
                                                     source)}
    assert built == {(h, n, k) for h, n in fc.TRAIN_FAMILIES for k in fc.nxh_lane_counts(h)}


def _host_param_pass(lib, n_layers, width, seed):
    """Pass 3 on the host (host_param_cotangents) against autograd of the
    plain MLP (mlp_param_vjp_plain) on a random root and streams of 3 x 67
    samples, every leaf within 2e-5 of its largest magnitude (float32 sums
    over 3 x 67 samples in another order); the jobs' entries fall on every
    leaf exactly once.  Returns the plan (S, G)."""
    b, t = 3, 67
    mlp = NeuralDiodeRoot(name="dp", n_layers=n_layers, layer_size=width).init_params(
        "cpu", torch.Generator().manual_seed(seed))["dp"]
    H, L, w = fc.train_weights(mlp, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    a_seq = torch.from_numpy(rng.uniform(-3.0, 3.0, (b, t)).astype(np.float32))
    log_r = torch.from_numpy(rng.uniform(6.5, 8.5, b).astype(np.float32))
    G = torch.from_numpy(rng.standard_normal((b, t)).astype(np.float32))
    n = sum(x.numel() for x in ct.mlp_leaves(mlp))
    leaf = torch.empty(4 * 32 * 64, dtype=torch.int32)  # up to 4 groups of 64 entries a lane
    plan = torch.empty(2, dtype=torch.int32)
    entries = lib.host_param_leaves(H, L, leaf.data_ptr(), plan.data_ptr())
    shares, groups = plan.tolist()
    block = 4 * min(H, 8) + min(H, 8)  # 4 x N products and the N sums of d beside them
    assert entries == groups * 32 * (block + 8)
    placed = leaf[:entries][leaf[:entries] >= 0]
    assert sorted(placed.tolist()) == list(range(n))
    out = torch.full((n,), float("nan"))
    lib.host_param_cotangents(H, a_seq.data_ptr(), log_r.data_ptr(), G.data_ptr(), b, t,
                              w.data_ptr(), L, out.data_ptr())
    want = ct.mlp_param_vjp_plain(mlp, ("tanh",) * (L + 1) + ("linear",), a_seq, log_r, G)
    got = [x.view(y.shape) for x, y in zip(out.split([y.numel() for y in want]), want)]
    for k, (g, y) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(g).all()), k
        scale = float(y.abs().max())
        np.testing.assert_allclose((g / scale).numpy(), (y / scale).numpy(), atol=2e-5, rtol=0,
                                   err_msg=f"leaf {k}")
    return shares, groups


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("width", [4, 8, 16])
def test_host_param_pass_matches_autograd(lib, n_layers, width):
    """Pass 3's arithmetic on the host: param_sample (one sample's forward at
    a and its backward from dy = -G) at every sample into its record, the
    outer products summed by every lane's block and unit (param_job, each over
    its share of a tile of 32 samples, param_accumulate), the shares added
    and placed by param_leaf, against torch.autograd of the plain MLP
    (mlp_param_vjp_plain): every leaf within 2e-5 of its largest magnitude,
    the jobs' entries on every leaf exactly once, in one group."""
    assert _host_param_pass(lib, n_layers, width, 31 * width + n_layers)[1] == 1


@pytest.mark.parametrize("n_layers,width,groups", [(3, 16, 1), (5, 16, 2), (3, 8, 1), (33, 4, 2)])
def test_host_param_pass_outside_the_families(lib, n_layers, width, groups):
    """Pass 3 takes every L at H = 4, 8, 16, not only the lane kernel's
    families: where the blocks do not fill the lanes evenly some lanes repeat
    a sum that is not kept (3x16, 3x8), and where they outnumber the lanes the
    plan splits them into groups, each running the samples again (5x16,
    33x4); the cotangents still match autograd within 2e-5 of scale."""
    assert _host_param_pass(lib, n_layers, width, 7 * width + n_layers)[1] == groups


def test_param_plan_balances_the_lanes(lib):
    """At the lane kernel's families every lane of a warp holds one block of
    the hidden layers' entries (4 x 8, 4 x 4 at H = 4) and no lane repeats
    another's: the blocks times the lanes that share each (S, each over 32 /
    S samples of a tile) make 32, in one group."""
    leaf = torch.empty(4 * 32 * 64, dtype=torch.int32)
    plan = torch.empty(2, dtype=torch.int32)
    want = {(16, 1): 4, (16, 2): 2, (8, 2): 8, (8, 4): 4, (4, 2): 16, (4, 4): 8}
    assert sorted(want) == sorted(fc.TRAIN_FAMILIES)
    for (h, n_layers), shares in want.items():
        lib.host_param_leaves(h, n_layers, leaf.data_ptr(), plan.data_ptr())
        assert plan.tolist() == [shares, 1], (h, n_layers)
        blocks = n_layers * (h // 4) * (h // min(h, 8))
        assert blocks * shares == 32, (h, n_layers)
