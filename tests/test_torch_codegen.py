"""The CUDA source generator of the generic fused circuit, on the CPU.

The generated per-sample steps are functions of plain C, so the host C++
compiler builds them here with a small stand-in for ``cuda_runtime.h`` that
defines the CUDA qualifiers and rounding intrinsics away; a ctypes harness
(``host_source``) drives them.  The forward step runs over B=8 streams of
T=256 samples for the Tube Screamer (analytic and pretrained 2x16), the HPF
clipper (analytic and HPF-trained 2x16), the LPF clipper with a distilled
root and the RC lowpass, held against the plain version within the JAX
suite's 2e-5, and with per-row and per-sample pots, writing the state
trajectory.  The adjoint step runs t = T-1 ... 0 over the plain forward's
trajectory for the Tube Screamer (analytic and random-init 2x8), the HPF
clipper, the training clipper with a per-sample pot and the distilled LPF
clipper, held against
``fused_backward_plain`` (autograd of the plain step) within the JAX suite's
relative budgets; its two passes as the card runs them (pass 1 into the
kernels' scratch layout, pass 2 walking it back, whole and in time chunks)
give the one-pass step's bits for the Tube Screamer (analytic, 2x16, 2x8,
with and without per-row and per-sample pots), the HPF and the LPF
clippers (the distilled root's adjoint and DEER steps on its forward-mode
Clenshaw slope among them).  The NxH root's lane form (csrc/nxh_lanes.cuh, and the generated
lane step for every r_kind at every K, and for roots of width 4, 8 and 16
at the K built for each) runs on K host threads per stream, its shuffles
through a stand-in, and every lane gives the one-thread step's bits; so
does the diode pair's lane form (its two omega solves on a pair of host
threads) for the LPF, HPF and Tube Screamer with the "best" and "low"
roots, with a per-row and a per-sample R and the trajectory, the one-thread
step within the JAX suite's 2e-5 of JAX's ``fused_circuit_process`` in
interpret mode; the lane form's tree check refuses an altered tree line;
and ``omega_select`` against ``omega()`` on the host (the same bits where
the host compiler's arithmetic is the card's).  The tests also show that
the source depends on the structure only (two drive settings, one source; a
scalar and a per-row R6, two), that an unknown node or root class raises,
that an MLP root outside the NxH family has no tangent emitter, and that the
generated-build path caches by source and raises on a failed compile (with
a stand-in compiler).
"""

import ctypes
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from diffwdf_tpu_torch.core.circuit import Circuit, Root
from diffwdf_tpu_torch.core.elements import Resistor, WDFNode
from diffwdf_tpu_torch.models import diode_clipper as tdc
from diffwdf_tpu_torch.models import simple_circuits as tsc
from diffwdf_tpu_torch.models import tube_screamer as tts
from diffwdf_tpu_torch.ops import _build
from diffwdf_tpu_torch.ops import circuit_codegen as cg
from diffwdf_tpu_torch.ops import clipper_train as ct
from diffwdf_tpu_torch.ops import fused_circuit as tfc
from diffwdf_tpu_torch.ops import parallel_bptt as pb
from diffwdf_tpu_torch.roots.diode import diode_1n4148_1u1d
from diffwdf_tpu_torch.roots.distilled import distill_root
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot
from diffwdf_tpu_torch.runtime.profiler import span

FS = 96000.0
B, T = 8, 256

#: the package's stand-in for cuda_runtime.h (ops/csrc/host_standin.h, the
#: header of _build.host_library): the CUDA qualifiers defined away
CUDA_RUNTIME_STANDIN = _build.HOST_STANDIN.read_text()


@pytest.fixture(scope="module")
def host_cxx(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    inc = tmp_path_factory.mktemp("standin")
    (inc / "cuda_runtime.h").write_text(CUDA_RUNTIME_STANDIN)
    out = tmp_path_factory.mktemp("host_build")

    def build(name: str, source: str) -> ctypes.CDLL:
        src, so = out / f"{name}.cpp", out / f"{name}.so"
        src.write_text(source)
        proc = subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-x", "c++", f"-I{inc}",
                               f"-I{_build.CSRC_DIR}", "-o", str(so), str(src)],
                              capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
        lib = ctypes.CDLL(str(so))
        vp, i = ctypes.c_void_p, ctypes.c_int
        if hasattr(lib, "circuit_host_run"):
            lib.circuit_host_run.argtypes = [vp] * 5 + [i] * 2 + [vp] * 4
        if hasattr(lib, "circuit_adjoint_host_run"):
            lib.circuit_adjoint_host_run.argtypes = [vp] * 7 + [i] * 2 + [vp] * 4
        if hasattr(lib, "circuit_jacobian_host_run"):
            lib.circuit_jacobian_host_run.argtypes = [vp] * 5 + [i] * 4 + [vp] * 4
            lib.circuit_recursion_host_run.argtypes = [vp] * 6 + [i] * 4
        if hasattr(lib, "circuit_lanes_host_run"):
            lib.circuit_lanes_host_run.argtypes = [i] + [vp] * 5 + [i] * 2 + [vp] * 4
        return lib

    return build


# A group of K lanes on the host: one thread per lane, __shfl_sync through a
# shared array between two barriers (the lane form of the NxH root,
# csrc/nxh_lanes.cuh, runs unchanged).
LANE_SHUFFLE_STANDIN = """
#include <pthread.h>
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct standin_group { float x[32]; pthread_barrier_t bar; };
static thread_local standin_group* standin_current;
static thread_local int standin_rank;
static inline float __shfl_sync(unsigned, float v, int src, int width) {
  standin_current->x[standin_rank] = v;
  pthread_barrier_wait(&standin_current->bar);
  const float got = standin_current->x[(standin_rank / width) * width + src];
  pthread_barrier_wait(&standin_current->bar);
  return got;
}
"""

# Run fn(rank) on K threads that form one group of lanes.
LANE_GROUP_HARNESS = """
#include <cuda_runtime.h>
#include <thread>
#include <vector>
template <class F>
static void standin_run_group(int K, F fn) {
  standin_group group;
  pthread_barrier_init(&group.bar, nullptr, K);
  std::vector<std::thread> lanes;
  for (int rank = 0; rank < K; ++rank) {
    lanes.emplace_back([&group, &fn, rank] {
      standin_current = &group;
      standin_rank = rank;
      fn(rank);
    });
  }
  for (auto& lane : lanes) lane.join();
  pthread_barrier_destroy(&group.bar);
}
"""


@pytest.fixture(scope="module")
def host_lanes_cxx(tmp_path_factory, host_cxx):
    """host_cxx with the lane stand-in: ``__shfl_sync`` between the threads
    of a group (``LANE_SHUFFLE_STANDIN``)."""
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    inc = tmp_path_factory.mktemp("standin_lanes")
    (inc / "cuda_runtime.h").write_text(CUDA_RUNTIME_STANDIN + LANE_SHUFFLE_STANDIN)
    out = tmp_path_factory.mktemp("host_lanes_build")

    def build(name: str, source: str) -> ctypes.CDLL:
        src, so = out / f"{name}.cpp", out / f"{name}.so"
        src.write_text(source)
        proc = subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-x",
                               "c++", f"-I{inc}", f"-I{_build.CSRC_DIR}", "-o", str(so),
                               str(src)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
        lib = ctypes.CDLL(str(so))
        vp, i = ctypes.c_void_p, ctypes.c_int
        if hasattr(lib, "circuit_lanes_host_run"):
            lib.circuit_lanes_host_run.argtypes = [i] + [vp] * 5 + [i] * 2 + [vp] * 4
        return lib

    return build


def _vin(seed, amp):
    rng = np.random.default_rng(seed)
    n = np.arange(T)
    x = amp * np.sin(2 * np.pi * 1000.0 * n / FS)[None, :] + 0.1 * rng.standard_normal((B, T))
    return torch.from_numpy(x.astype(np.float32))


def _case(name):
    """(circuit, params, input node, amplitude)."""
    if name.startswith("ts"):
        root, rp = tdc.make_root_from_zoo(4 if name == "ts_2x16" else 0, device="cpu")
        ckt = tts.make_tube_screamer(root, FS, drive=0.5)
        return ckt, {**ckt.init_params("cpu"), **rp}, "Vin", 0.2
    if name.startswith("hpf"):
        root, rp = tdc.make_hpf_root_from_zoo(3 if name == "hpf_2x16" else 0, device="cpu")
        ckt = tdc.make_hpf_diode_clipper(root, FS)
        return ckt, {**ckt.init_params("cpu"), **rp}, "Vs", 1.5
    if name == "distilled":  # the LPF clipper with the distilled 1N4148 root
        root, rp = tdc.make_root_from_zoo(0, device="cpu")
        droot, _ = distill_root(root, rp, 1.0 / (1.0 / 47.0e3 + 2.0 * 2.2e-9 * FS))
        ckt = tdc.make_diode_clipper(droot, FS)
        return ckt, ckt.init_params("cpu"), "Vs", 2.0
    ckt = tsc.make_rc_lowpass(FS)
    return ckt, ckt.init_params("cpu"), "Vs", 1.0


def _state(ckt, b=B):
    return {k: {f: torch.zeros(b) for f in d} for k, d in ckt.init_state("cpu").items()}


def _ptr(x, fallback):
    return (x if x is not None and x.numel() else fallback).data_ptr()


def _host_forward(lib, prep, vin, state, with_seq=True):
    """(out, z_final (S, B), trajectory (S, B, T)) of the host-compiled
    forward step over ``vin``."""
    b, t = vin.shape
    z0 = tfc._state_stack(prep.prog, state, vin)
    out, zf = torch.empty_like(vin), torch.empty_like(z0)
    seq = torch.empty((z0.shape[0], b, t))
    lib.circuit_host_run(vin.data_ptr(), z0.data_ptr(), out.data_ptr(), zf.data_ptr(),
                         seq.data_ptr() if with_seq else None, b, t, prep.vec.data_ptr(),
                         _ptr(prep.rows, prep.vec), _ptr(prep.times, prep.vec),
                         _ptr(prep.warr, prep.vec))
    return out, zf, seq


@pytest.mark.parametrize("name", ["ts", "ts_2x16", "hpf", "hpf_2x16", "distilled", "rc"])
def test_host_compiled_step_matches_plain(host_cxx, name):
    ckt, params, node, amp = _case(name)
    vin = _vin(len(name), amp)
    want, want_state = tfc.fused_circuit_process_plain(ckt, params, vin, _state(ckt),
                                                       input_node=node)
    prep = tfc.prepare(ckt, params, "cpu", input_node=node)
    out, zf, _ = _host_forward(host_cxx(name, prep.prog.host_source), prep, vin, _state(ckt))
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-5, rtol=0)
    for k, (n, f) in enumerate(prep.prog.state_order):
        np.testing.assert_allclose(zf[k].numpy(), want_state[n][f].numpy(), atol=2e-5, rtol=0)


def _pot_case(name):
    """(circuit, params, input node, amplitude, row controls (B,) or (B, T))."""
    rng = np.random.default_rng(len(name))
    if name == "ts_row":  # a per-row drive pot on the Tube Screamer, 2x8 root
        root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8)
        ckt = tts.make_tube_screamer(root, FS, drive=0.5)
        r6 = tts.drive_to_r6(rng.uniform(0.0, 1.0, B)).astype(np.float32)
        return (ckt, {**ckt.init_params("cpu"), **root.init_params("cpu")}, "Vin", 0.3,
                {"R6": {"R": torch.from_numpy(r6)}})
    if name == "ts_sample":  # a per-sample drive pot, analytic root
        root = tdc.DiodePairRoot(name="dp", diode=diode_1n4148_1u1d)
        ckt = tts.make_tube_screamer(root, FS, drive=0.5)
        drive = np.clip(0.5 + np.cumsum(0.01 * rng.standard_normal((B, T)), axis=1), 0.0, 1.0)
        return (ckt, {**ckt.init_params("cpu"), **root.init_params("cpu")}, "Vin", 0.3,
                {"R6": {"R": torch.from_numpy(tts.drive_to_r6(drive).astype(np.float32))}})
    # the training clipper with a random-walk source R per sample
    root = tdc.DiodePairRoot(name="dp", diode=diode_1n4148_1u1d)
    ckt = tdc.make_training_clipper(root, FS)
    r = np.exp(np.log(45e3) + np.cumsum(0.02 * rng.standard_normal((B, T)), axis=1))
    return (ckt, {**ckt.init_params("cpu"), **root.init_params("cpu")}, "Vs", 1.5,
            {"Vs": {"R": torch.from_numpy(r.astype(np.float32))}})


@pytest.mark.parametrize("name", ["ts_row", "ts_sample", "clipper_sample"])
def test_host_compiled_step_with_pots_matches_plain(host_cxx, name):
    """Per-row and per-sample pot slots, and the trajectory output."""
    ckt, params, node, amp, rows = _pot_case(name)
    vin = _vin(len(name) + 1, amp)
    want, want_state, want_seq = tfc.fused_circuit_process_plain(
        ckt, params, vin, _state(ckt), input_node=node, row_controls=rows,
        return_state_seq=True)
    prep = tfc.prepare(ckt, params, "cpu", input_node=node, row_controls=rows, shape=(B, T))
    assert prep.prog.n_rows + prep.prog.n_times > 0
    out, zf, seq = _host_forward(host_cxx(name, prep.prog.host_source), prep, vin, _state(ckt))
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-5, rtol=0)
    for k, (n, f) in enumerate(prep.prog.state_order):
        np.testing.assert_allclose(zf[k].numpy(), want_state[n][f].numpy(), atol=2e-5, rtol=0)
        np.testing.assert_allclose(seq[k].numpy(), want_seq[k].numpy(), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(want_seq[0][:, 0].numpy(), 0.0)  # z_{-1} = z0


def _adjoint_case(name):
    if name in ("ts_row", "ts_sample", "clipper_sample"):
        return _pot_case(name)
    if name == "ts_2x8":
        root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8)
        ckt = tts.make_tube_screamer(root, FS, drive=0.5)
        return ckt, {**ckt.init_params("cpu"), **root.init_params("cpu")}, "Vin", 0.3, None
    ckt, params, node, amp = _case(name)
    return ckt, params, node, amp, None


def _rel(got, want):
    return float((got - want).abs().max() / max(float(want.abs().max()), 1e-12))


@pytest.mark.parametrize("name", ["ts", "ts_2x8", "hpf", "ts_row", "clipper_sample",
                                  "distilled"])
def test_host_compiled_adjoint_matches_plain(host_cxx, name):
    """The generated adjoint step (S + 1 forward-mode tangents) against the
    autograd VJP of the plain step, over the plain forward's trajectory."""
    ckt, params, node, amp, rows = _adjoint_case(name)
    vin = _vin(len(name) + 2, amp)
    _, _, seq = tfc.fused_circuit_process_plain(ckt, params, vin, _state(ckt), input_node=node,
                                                row_controls=rows, return_state_seq=True)
    rng = np.random.default_rng(5)
    g_out = torch.from_numpy(rng.standard_normal((B, T)).astype(np.float32))
    lam_T = [torch.from_numpy(rng.standard_normal(B).astype(np.float32)) for _ in seq]
    want = pb.fused_backward_plain(ckt, params, vin, g_out, seq, lam_T, input_node=node,
                                   row_controls=rows)
    prep = tfc.prepare(ckt, params, "cpu", input_node=node, row_controls=rows, shape=(B, T))
    adj = cg.adjoint_program(ckt, prep.prog)
    assert adj.ops_per_sample > 0
    assert "circuit_jacobian_kernel" in adj.source and "circuit_recursion_kernel" in adj.source
    assert "circuit_adjoint_step(" in adj.host_source
    assert "circuit_adjoint_step(" not in adj.source
    lib = host_cxx(name + "_adjoint", adj.host_source)
    S = len(seq)
    lam_seq, g_vin, g_z0 = torch.empty((S, B, T)), torch.empty_like(vin), torch.empty((S, B))
    zseq, lam_t = torch.stack(seq), torch.stack(lam_T)  # held while the host loop runs
    lib.circuit_adjoint_host_run(vin.data_ptr(), g_out.data_ptr(), zseq.data_ptr(),
                                 lam_t.data_ptr(), lam_seq.data_ptr(),
                                 g_vin.data_ptr(), g_z0.data_ptr(), B, T, prep.vec.data_ptr(),
                                 _ptr(prep.rows, prep.vec), _ptr(prep.times, prep.vec),
                                 _ptr(prep.warr, prep.vec))
    budget = 3e-4 if rows else 1e-4  # tests/test_parallel_bptt.py:303,537
    assert _rel(g_vin, want[1]) < budget
    for k in range(S):
        assert _rel(lam_seq[k], want[0][k]) < budget, k
        assert _rel(g_z0[k], want[2][k]) < budget, k


def _two_pass_case(name):
    """_adjoint_case's cases, the pretrained Tube Screamer 2x16 with a drive
    pot per row and per sample, and the LPF clipper (analytic root)."""
    if name in ("ts_2x16_row", "ts_2x16_sample"):
        ckt, params, node, amp = _case("ts_2x16")
        rng = np.random.default_rng(len(name))
        if name == "ts_2x16_row":
            drive = rng.uniform(0.0, 1.0, B)
        else:
            drive = np.clip(0.5 + np.cumsum(0.01 * rng.standard_normal((B, T)), axis=1), 0.0, 1.0)
        r6 = torch.from_numpy(tts.drive_to_r6(drive).astype(np.float32))
        return ckt, params, node, amp, {"R6": {"R": r6}}
    if name == "lpf":
        root = tdc.DiodePairRoot(name="dp", diode=diode_1n4148_1u1d)
        ckt = tdc.make_diode_clipper(root, FS)
        return ckt, {**ckt.init_params("cpu"), **root.init_params("cpu")}, "Vs", 1.5, None
    return _adjoint_case(name)


def _host_two_pass(lib, adj, prep, vin, g_out, zseq, lam_t, tc, streams=None):
    """(lam_seq, g_vin, g_z0) of the host-compiled pass 1 and pass 2 over
    time chunks of tc samples, last chunk first, in the kernels' scratch
    layout, as launch_adjoint runs them; ``streams`` (a, G), two (B, T)
    tensors the passes fill with the root's streams where the program has
    them (None: two of this function's own)."""
    b, t = vin.shape
    S = zseq.shape[0]
    lam_seq, g_vin, g_z0 = torch.empty((S, b, t)), torch.empty_like(vin), torch.empty((S, b))
    streams = streams or (torch.empty_like(vin), torch.empty_like(vin))
    a_ptr, g_ptr = (x.data_ptr() for x in streams)
    lam_in = lam_t
    for t0 in range(((t - 1) // tc) * tc, -1, -tc):
        n = min(tc, t - t0)
        jac = torch.full((adj.scratch_floats(b, n),), float("nan"))
        lib.circuit_jacobian_host_run(vin.data_ptr(), g_out.data_ptr(), zseq.data_ptr(),
                                      jac.data_ptr(), a_ptr, b, t, t0, n, prep.vec.data_ptr(),
                                      _ptr(prep.rows, prep.vec), _ptr(prep.times, prep.vec),
                                      _ptr(prep.warr, prep.vec))
        lib.circuit_recursion_host_run(jac.data_ptr(), lam_in.data_ptr(), g_z0.data_ptr(),
                                       lam_seq.data_ptr(), g_vin.data_ptr(), g_ptr, b, t, t0, n)
        lam_in = g_z0
    return lam_seq, g_vin, g_z0


TWO_PASS_CASES = ["ts", "ts_2x16", "ts_2x16_row", "ts_2x16_sample", "ts_row", "ts_sample", "hpf",
                  "lpf", "clipper_sample", "distilled"]


@pytest.mark.parametrize("name", TWO_PASS_CASES)
def test_host_compiled_two_pass_adjoint_equals_one_pass(host_cxx, name):
    """The device's two passes compiled for the host (pass 1 into the
    scratch layout of the kernels, pass 2 walking it back; all of T in one
    chunk, and three time chunks of 96, 96 and 64 samples) give the
    one-pass adjoint step's bits, and hold the JAX suite's relative budgets
    against
    fused_backward_plain (tests/test_parallel_bptt.py:303,537)."""
    ckt, params, node, amp, rows = _two_pass_case(name)
    vin = _vin(len(name) + 4, amp)
    _, _, seq = tfc.fused_circuit_process_plain(ckt, params, vin, _state(ckt), input_node=node,
                                                row_controls=rows, return_state_seq=True)
    rng = np.random.default_rng(17)
    g_out = torch.from_numpy(rng.standard_normal((B, T)).astype(np.float32))
    lam_T = [torch.from_numpy(rng.standard_normal(B).astype(np.float32)) for _ in seq]
    prep = tfc.prepare(ckt, params, "cpu", input_node=node, row_controls=rows, shape=(B, T))
    adj = cg.adjoint_program(ckt, prep.prog)
    S = len(seq)
    assert adj.n_state == S and 0 < adj.n_entries <= (S + 1) * (S + 1 + adj.root_streams)
    assert "circuit_jacobian_kernel" in adj.source and "circuit_recursion_kernel" in adj.source
    assert adj.jacobian_ops + adj.recursion_ops >= adj.ops_per_sample
    lib = host_cxx(name + "_two_pass", adj.host_source)
    zseq, lam_t = torch.stack(seq).contiguous(), torch.stack(lam_T).contiguous()
    one = (torch.empty((S, B, T)), torch.empty_like(vin), torch.empty((S, B)))
    lib.circuit_adjoint_host_run(vin.data_ptr(), g_out.data_ptr(), zseq.data_ptr(),
                                 lam_t.data_ptr(), one[0].data_ptr(), one[1].data_ptr(),
                                 one[2].data_ptr(), B, T, prep.vec.data_ptr(),
                                 _ptr(prep.rows, prep.vec), _ptr(prep.times, prep.vec),
                                 _ptr(prep.warr, prep.vec))
    for tc in (T, 96):
        two = _host_two_pass(lib, adj, prep, vin, g_out, zseq, lam_t, tc)
        for got, want in zip(two, one):
            assert torch.equal(got, want), (tc, float((got - want).abs().max()))
    want = pb.fused_backward_plain(ckt, params, vin, g_out, seq, lam_T, input_node=node,
                                   row_controls=rows)
    budget = 3e-4 if rows else 1e-4
    assert _rel(two[1], want[1]) < budget
    for k in range(S):
        assert _rel(two[0][k], want[0][k]) < budget, k
        assert _rel(two[2][k], want[2][k]) < budget, k


def test_adjoint_scratch_chunks_under_the_cap():
    """The scratch of (B, T) is E floats a sample (padded to 4) over the
    stream groups of 8 of pass 2; past the cap, time runs in chunks of a
    multiple of 32 samples."""
    ckt, params, node, _ = _case("ts_2x16")
    adj = cg.adjoint_program(ckt, tfc.prepare(ckt, params, "cpu", input_node=node).prog)
    # (S + 1)^2 = 16 for the Tube Screamer (no tangent is constant), then its
    # NxH root's b column: dz/db of the three states and do/db obar
    assert adj.root_streams and adj.n_entries == 16 + 3
    assert 4 * adj.scratch_floats(1024, 2048) == 167_772_160  # 168 MB at (1024, 2048)
    assert adj.chunk(1024, 2048) == 2048 and adj.chunk(375, 2048) == 2048
    tc = adj.chunk(8192, 2048)
    assert tc % 32 == 0 and tc < 2048
    assert 4 * adj.scratch_floats(8192, tc) <= adj.SCRATCH_CAP_BYTES
    assert adj.GROUP == 8 and "#define CIRCUIT_GROUP 8" in adj.source
    assert adj.scratch_floats(33, 10) == 20 * 40 * 10  # five groups of 8 streams
    assert adj.scratch_floats(375, 1) == 20 * 376 and adj.scratch_floats(1, 3) == 20 * 8 * 3


def _route_case(name):
    """_two_pass_case's cases and a Tube Screamer with a relu-mixed 2x8 root
    (a general MLP root: no tangent emitter, so no generated adjoint)."""
    if name == "ts_relu":
        root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8,
                               activations=("tanh", "relu", "tanh", ""))
        ckt = tts.make_tube_screamer(root, FS, drive=0.5)
        return ckt, {**ckt.init_params("cpu"), **root.init_params("cpu")}, "Vin", 0.3, None
    if name == "hpf_2x16":
        ckt, params, node, amp = _case(name)
        return ckt, params, node, amp, None
    return _two_pass_case(name)


def _host_fused_backward(host_cxx, name, writes=True):
    """``parallel_bptt.fused_backward`` as the card runs it, on the host: the
    program's two passes (time chunks of 96 samples) with the root's streams
    where the program has them (never, with ``writes`` False: the route of
    a program without them)."""

    def fused_backward(circuit, params, vin, g_out, z_prev, lam_T, *, input_node,
                       static_controls=None, row_controls=None, neural_mlp=None):
        prep = tfc.prepare(circuit, params, "cpu", input_node=input_node,
                           static_controls=static_controls, row_controls=row_controls,
                           neural_mlp=neural_mlp, shape=tuple(vin.shape))
        adj = cg.adjoint_program(circuit, prep.prog)
        lib = host_cxx(f"{name}_route_{adj.root_streams}", adj.host_source)
        streams = (torch.empty_like(vin), torch.empty_like(vin))
        lam_seq, g_vin, g_z0 = _host_two_pass(lib, adj, prep, vin, g_out,
                                              torch.stack(list(z_prev)).contiguous(),
                                              torch.stack(list(lam_T)).contiguous(), 96, streams)
        root = pb.RootStreams(*streams, pb._log_r(prep, B)) if writes and adj.root_streams \
            else None
        return list(lam_seq), g_vin, list(g_z0), root

    return fused_backward


def _host_param_launch(mlp, a_seq, log_r, G, launch_span):
    """``clipper_train.launch_param_vjp`` on the host: the plain VJP of the
    all-tanh NxH MLP, inside the span the launch opens."""
    acts = ("tanh",) * (len(mlp["layers"]) - 1) + ("",)
    with span(launch_span):
        return ct.mlp_param_vjp_plain(mlp, acts, a_seq, log_r, G)


def _head_bias_gap(got, G) -> float:
    """|got - (-sum G)| of the head's bias, the sum taken in double, over
    float32's epsilon times sum |G|: the head's bias sums -G over every
    sample and can cancel to ~1e-6 of its terms, so it is held to the
    rounding of the sum rather than to its own size."""
    exact = -float(G.double().sum())
    return abs(float(got) - exact) / (float(torch.finfo(torch.float32).eps)
                                      * float(G.double().abs().sum()))


#: (case, whether B8 writes the root's streams for the parameter pass)
ROUTE_CASES = [("ts_2x16", True), ("ts_row", True), ("hpf_2x16", True), ("ts_2x8", True),
               ("ts_2x16_sample", False), ("ts_relu", False), ("distilled", False)]


@pytest.mark.parametrize("name,streams", ROUTE_CASES)
def test_root_streams_route_matches_autograd(host_cxx, name, streams, monkeypatch):
    """The parameter pass through B8's root streams: for an NxH root whose
    R_up is one value (the Tube Screamer 2x16 and 2x8, the HPF 2x16) or one
    per row (the TS 2x8 with its drive per row), the host build of the two
    passes writes the root's incident wave a (2e-5) and G (the budget of
    lam) as ``fused_backward_plain`` does, and the root's leaves from pass
    3 (its host stand-in, ``mlp_param_vjp_plain``) on them hold the JAX
    suite's 5e-4 per leaf (scaled as :func:`_gap` says; the head's bias
    within 16 epsilon of sum |G| of the exact sum of -G) against today's
    autograd pass over the same lam, the other leaves autograd's bits; only
    the leaves that need a gradient are computed, and pass 3 runs only
    where a root leaf is one of them.  Through the engine's op (B8 the host
    build), the same.  A per-sample R_up, a general MLP root and the
    distilled root have no streams and keep autograd's pass: the op's
    cotangents the bits of autograd's."""
    ckt, params, node, amp, rows = _route_case(name)
    vin = _vin(len(name) + 6, amp)
    _, _, seq = tfc.fused_circuit_process_plain(ckt, params, vin, _state(ckt), input_node=node,
                                                row_controls=rows, return_state_seq=True)
    rng = np.random.default_rng(23)
    g_out = torch.from_numpy(rng.standard_normal((B, T)).astype(np.float32))
    lam_T = [torch.from_numpy(rng.standard_normal(B).astype(np.float32)) for _ in seq]
    prep = tfc.prepare(ckt, params, "cpu", input_node=node, row_controls=rows, shape=(B, T))
    assert cg.root_streams(prep.prog.emitter) == streams
    kw = dict(input_node=node, row_controls=rows)
    monkeypatch.setattr(ct, "launch_param_vjp", _host_param_launch)
    leaves, _ = pb._flatten(params)
    in_root = [isinstance(ckt.root, NeuralDiodeRoot)
               and any(x is y for y in ct.mlp_leaves(params["dp"])) for x in leaves]
    if name != "ts_relu":  # a general MLP root has no generated adjoint
        adj = cg.adjoint_program(ckt, prep.prog)
        assert adj.root_streams == streams
        assert f"#define CIRCUIT_ROOT_STREAMS {int(streams)}" in adj.source
    if streams:
        lib = host_cxx(name + "_streams", adj.host_source)
        zseq, lam_t = torch.stack(seq).contiguous(), torch.stack(lam_T).contiguous()
        a_seq, G = torch.full((B, T), float("nan")), torch.full((B, T), float("nan"))
        lam_step, g_vin, g_z0 = _host_two_pass(lib, adj, prep, vin, g_out, zseq, lam_t, 96,
                                               (a_seq, G))
        ref = pb.fused_backward_plain(ckt, params, vin, g_out, seq, lam_T, **kw)[3]
        np.testing.assert_allclose(a_seq.numpy(), ref.a_seq.numpy(), atol=2e-5, rtol=0)
        assert _rel(G, ref.G) < (3e-4 if rows else 1e-4)
        assert torch.equal(ref.log_r, pb._log_r(prep, B))
        lam_step = list(lam_step)
        want = pb.parameter_cotangents(ckt, params, vin, seq, g_out, lam_step, **kw)
        root = pb.RootStreams(a_seq, G, pb._log_r(prep, B))
        got = pb.parameter_cotangents(ckt, params, vin, seq, g_out, lam_step, root=root, **kw)
        scale = _root_scale(want, in_root)
        for x, w, g, r in zip(leaves, want, got, in_root):
            if r:
                assert _gap(g, w, scale) < 5e-4, (x.shape, _gap(g, w, scale))
            else:
                assert (g is None and w is None) or torch.equal(g, w)
        head_bias = ct.mlp_leaves(params["dp"])[-1]
        (bias_got,) = [g for x, g in zip(leaves, got) if x is head_bias]
        assert _head_bias_gap(bias_got, G) < 16, _head_bias_gap(bias_got, G)
        launches = pb.root_param_vjp.launches
        only = pb.parameter_cotangents(ckt, params, vin, seq, g_out, lam_step, root=root,
                                       needs=in_root, **kw)
        assert all((o is None) != r for o, r in zip(only, in_root))
        assert all(torch.equal(o, g) for o, g, r in zip(only, got, in_root) if r)
        rest = pb.parameter_cotangents(ckt, params, vin, seq, g_out, lam_step, root=root,
                                       needs=[not r for r in in_root], **kw)
        assert pb.root_param_vjp.launches == launches + 1  # no pass 3 for no root leaf
        assert all(o is None for o, r in zip(rest, in_root) if r)
        assert all((o is None and g is None) or torch.equal(o, g)
                   for o, g, r in zip(rest, got, in_root) if not r)
    elif name != "ts_relu":
        assert pb.fused_backward_plain(ckt, params, vin, g_out, seq, lam_T, **kw)[3] is None
    if name == "ts_relu":  # the engine's forward takes NxH roots only
        return
    # the engine's op: every leaf, then only the root's, trained
    row_fields = tuple((n, f) for n, d in (rows or {}).items() for f in d)
    f = pb.make_fused_circuit_train_generic(ckt, input_node=node, row_fields=row_fields)
    row_vals = [x for d in (rows or {}).values() for x in d.values()]
    y = torch.from_numpy(rng.standard_normal((B, T)).astype(np.float32))

    def grads(which):
        p_leaves = [x.detach().clone().requires_grad_(w) for x, w in zip(leaves, which)]
        p = pb._flatten(params)[1](p_leaves)
        z0 = [torch.zeros(B) for _ in seq]
        out, zf = f(p, vin, z0, row_vals) if row_fields else f(p, vin, z0)
        loss = ((out - y) ** 2).sum() + sum((3.0 * z).sum() for z in zf)
        loss.backward()
        return [x.grad for x in p_leaves]

    monkeypatch.setattr(pb, "fused_backward", _host_fused_backward(host_cxx, name, False))
    want = grads([True] * len(leaves))  # the same lam, autograd's pass for every leaf
    scale = _root_scale(want, in_root) if streams else None
    monkeypatch.setattr(pb, "fused_backward", _host_fused_backward(host_cxx, name))
    for which in ([True] * len(leaves), in_root):
        if not any(which):
            continue
        got = grads(which)
        for x, w, g, r, on in zip(leaves, want, got, in_root, which):
            if not on or w is None:  # not asked for, or a leaf the step does not read
                assert g is None
            elif streams and r:
                assert _gap(g, w, scale) < 5e-4, (x.shape, _gap(g, w, scale))
            else:
                assert torch.equal(g, w), x.shape


def _root_scale(grads, in_root) -> float:
    """The median over the root's leaves of each leaf's largest |cotangent|:
    the floor of a leaf's scale in :func:`_gap`."""
    return float(np.median([float(g.abs().max()) for g, r in zip(grads, in_root) if r]))


def _gap(got, want, floor: float) -> float:
    """max |got - want| over the larger of want's largest magnitude and
    ``floor``: a one-element leaf that sums G over every sample (the head's
    bias) can cancel to ~1e-6 of its terms, leaving rounding in the order
    of the sum as its own size (the benchmark's grad_gap floors each leaf's
    scale at the median leaf for the same reason)."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), floor, 1e-12)


# nxh_forward (one thread) against nxh_forward_lanes on K host threads:
# every lane's y, and the bits of nxh_forward, from random weights
LANE_MLP_HARNESS = """
#include "nxh_mlp.cuh"
#include "nxh_lanes.cuh"
extern "C" void lane_mlp_run(const float* a, int n, const float* w, float* one, float* lanes,
                             float* lanes_local, float log_r) {{
  // w: w1a[H], w1r[H], b1[H], w3[H], b3, zeros to a multiple of 4, the hidden layers
  constexpr int H = {H}, K = {K}, L = {L};
  const float* hidden = w + (4 * H + 4) / 4 * 4;
  alignas(16) float c1[H];
  nxh_first_bias<H>(w + H, w + 2 * H, log_r, c1);
  for (int i = 0; i < n; ++i) one[i] = nxh_forward<H>(a[i], w, c1, hidden, L, w + 3 * H, w[4 * H]);
  standin_run_group(K, [&](int rank) {{
    float local[H / K];
    nxh_first_bias_lanes<H, K>(w + H, w + 2 * H, log_r, rank, local);
    NxhLaneWeights<H, K, L, true> regs;
    NxhLaneWeights<H, K, L, false> none;
    regs.load(hidden, w + 3 * H, rank);
    none.load(hidden, w + 3 * H, rank);
    for (int i = 0; i < n; ++i) {{
      lanes[rank * n + i] = nxh_forward_lanes<H, K, L, false>(a[i], w, c1, hidden, w + 3 * H,
                                                              w[4 * H], rank, none);
      lanes_local[rank * n + i] = nxh_forward_lanes<H, K, L, true>(a[i], w, local, hidden,
                                                                   w + 3 * H, w[4 * H], rank,
                                                                   regs);
    }}
  }});
}}
"""


@pytest.mark.parametrize("H,L,K", [(16, 2, 4), (16, 2, 8), (16, 2, 16), (8, 2, 4), (8, 2, 8),
                                   (4, 1, 4), (16, 0, 16), (4, 3, 4)])
def test_lane_mlp_matches_nxh_forward_on_host(host_lanes_cxx, H, L, K):
    """nxh_forward_lanes on a group of K lanes (host threads, the shuffles
    through the stand-in): every lane returns the same bits, those of the
    one-thread nxh_forward, with c1 shared (folded log R) and the weights
    read from the root array, and with c1 per lane (nxh_first_bias_lanes)
    and the weights held in registers."""
    lib = host_lanes_cxx(f"lane_mlp_{H}_{L}_{K}",
                         LANE_GROUP_HARNESS + LANE_MLP_HARNESS.format(H=H, K=K, L=L))
    vp = ctypes.c_void_p
    lib.lane_mlp_run.argtypes = [vp, ctypes.c_int] + [vp] * 4 + [ctypes.c_float]
    rng = np.random.default_rng(H * 100 + L * 10 + K)
    n = 64
    a = torch.from_numpy(rng.uniform(-3.0, 3.0, n).astype(np.float32))
    w = (rng.standard_normal((4 * H + 4) // 4 * 4 + L * (H * H + H)) / np.sqrt(H))
    w[4 * H + 1:(4 * H + 4) // 4 * 4] = 0.0
    w = torch.from_numpy(w.astype(np.float32))
    one, lanes, local = torch.empty(n), torch.empty(K, n), torch.empty(K, n)
    lib.lane_mlp_run(a.data_ptr(), n, w.data_ptr(), one.data_ptr(), lanes.data_ptr(),
                     local.data_ptr(), ctypes.c_float(np.log(47e3)))
    assert bool(torch.isfinite(one).all()) and float(one.abs().max()) > 0.0
    for k in range(K):
        assert torch.equal(lanes[k], one), k
        assert torch.equal(local[k], one), k


# The generated lane step (circuit_step_lanes) on K host threads per stream:
# every lane keeps its own copy of the state, output and trajectory
LANE_STEP_HARNESS = """
template <int K>
static void lanes_run(const float* vin, const float* z0, float* out, float* zf, float* seq,
                      int B, int T, const float* c, const float* rows, const float* times,
                      const float* w) {{
  // out (K, B, T), zf (K, S, B), seq (K, S, B, T): lane by lane
  constexpr int S = CIRCUIT_NS;
  for (int b = 0; b < B; ++b) {{
    standin_run_group(K, [&](int rank) {{
      float r[CIRCUIT_NR + 1], p[64], z[S + 1];
      for (int j = 0; j < CIRCUIT_NR; ++j) r[j] = rows[j * B + b];
      circuit_prologue_lanes<K>(c, r, w, p, rank);
      CircuitLaneWeights<K> lw;
      {load}
      for (int k = 0; k < S; ++k) z[k] = z0[k * B + b];
      for (long t = 0; t < T; ++t) {{
        float q[CIRCUIT_NQ + 1];
        for (int j = 0; j < CIRCUIT_NQ; ++j) q[j] = times[(j * B + b) * T + t];
        for (int k = 0; k < S; ++k) seq[((static_cast<long>(rank) * S + k) * B + b) * T + t] = z[k];
        out[(static_cast<long>(rank) * B + b) * T + t] =
            circuit_step_lanes<K>(vin[b * T + t], z, c, r, q, w, p, rank, lw);
      }}
      for (int k = 0; k < S; ++k) zf[(rank * S + k) * B + b] = z[k];
    }});
  }}
}}

extern "C" void circuit_lanes_host_run(int K, const float* vin, const float* z0, float* out,
                                       float* zf, float* seq, int B, int T, const float* c,
                                       const float* rows, const float* times, const float* w) {{
  switch (K) {{{cases}
  }}
}}
"""


@pytest.mark.parametrize("name", ["ts_2x16", "ts_2x16_row", "ts_2x16_sample", "clipper_2x16"])
def test_host_lane_step_matches_one_thread_step(host_cxx, host_lanes_cxx, name):
    """The forward's lane form for every r_kind (the folded R, a per-row and
    a per-sample R reaching the root), at every K of the sweep's build:
    on K host threads per stream every lane ends every step with the same
    state and output bits, those of the one-thread step (circuit_host_run),
    trajectory included."""
    if name == "clipper_2x16":  # the training clipper, random-init 2x16, R per sample
        root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
        ckt = tdc.make_training_clipper(root, FS)
        params, node, amp = {**ckt.init_params("cpu"), **root.init_params("cpu")}, "Vs", 1.5
        walk = np.cumsum(0.02 * np.random.default_rng(9).standard_normal((B, T)), axis=1)
        rows = {"Vs": {"R": torch.from_numpy(np.exp(np.log(45e3) + walk).astype(np.float32))}}
    else:
        ckt, params, node, amp, rows = _two_pass_case(name)
    b, t = 3, 64
    vin = _vin(len(name) + 5, amp)[:b, :t].contiguous()
    rows = None if rows is None else {n: {f: x[:b, :t].contiguous() if x.dim() == 2 else x[:b]
                                          for f, x in d.items()} for n, d in rows.items()}
    prep = tfc.prepare(ckt, params, "cpu", input_node=node, row_controls=rows, shape=(b, t))
    assert prep.prog.lanes == (1, 8, 16)  # the K that lanes_for picks for H = 16
    prog = cg.sweep_program(ckt, prep.prog)
    r_kind = {"ts_2x16": "scalar", "ts_2x16_row": "row"}.get(name, "time")
    assert prog.emitter.r_kind == r_kind and prog.lanes == (1, 4, 8, 16)
    assert "circuit_lanes_kernel" in prog.source and "nxh_forward_lanes" in prog.lanes_source
    assert "nxh_forward_lanes" not in prog.step_source  # B9 and the adjoint: nxh_mlp.cuh
    want = _host_forward(host_cxx(name + "_one_thread", prog.host_source), prep, vin,
                         _state(ckt, b))
    cases = "".join(f"\n    case {k}:\n      lanes_run<{k}>(vin, z0, out, zf, seq, B, T, c, rows, "
                    f"times, w);\n      break;" for k in prog.lanes[1:])
    lib = host_lanes_cxx(name + "_lanes", prog.step_source + prog.lanes_source
                         + LANE_GROUP_HARNESS
                         + LANE_STEP_HARNESS.format(cases=cases,
                                                    load=prog.emitter.lane_weights()[1]))
    S = len(prog.state_order)
    z0 = tfc._state_stack(prog, _state(ckt, b), vin)
    for K in prog.lanes[1:]:
        out, zf, seq = torch.empty(K, b, t), torch.empty(K, S, b), torch.empty(K, S, b, t)
        lib.circuit_lanes_host_run(K, vin.data_ptr(), z0.data_ptr(), out.data_ptr(),
                                   zf.data_ptr(), seq.data_ptr(), b, t, prep.vec.data_ptr(),
                                   _ptr(prep.rows, prep.vec), _ptr(prep.times, prep.vec),
                                   _ptr(prep.warr, prep.vec))
        for rank in range(K):
            assert torch.equal(out[rank], want[0]), (K, rank)
            assert torch.equal(zf[rank], want[1]), (K, rank)
            assert torch.equal(seq[rank], want[2]), (K, rank)


@pytest.mark.parametrize("H", [4, 8, 16])
def test_lane_kernels_follow_the_root_width(host_cxx, host_lanes_cxx, H):
    """An NxH root's forward is built with the lane form for the K that
    lanes_for can pick at its width (the sweep's build: every K of LANES
    that divides H), each K one case of the launch's switch.  The one-thread
    step is within 2e-5 of the plain version, and on K host threads per
    stream each lane of every built K has its bits."""
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=H)
    ckt = tts.make_tube_screamer(root, FS, drive=0.5)
    params = {**ckt.init_params("cpu"), **root.init_params("cpu")}
    b, t = 3, 64
    vin = _vin(H, 0.3)[:b, :t].contiguous()
    prep = tfc.prepare(ckt, params, "cpu", input_node="Vin")
    prog = prep.prog
    lanes = {4: (1, 4), 8: (1, 8), 16: (1, 8, 16)}[H]
    assert prog.lanes == lanes
    assert cg.sweep_program(ckt, prog).lanes == (1,) + tuple(k for k in cg.LANES if H % k == 0)
    assert [tfc.lanes_for(prog, n) for n in (1, 2048, 2049, 8192)] == (
        [16, 16, 8, 8] if H == 16 else [H] * 4)
    for k in prog.lanes:
        assert prog.source.count(f"case {k}:") == 1, k
    want, _, want_seq = tfc.fused_circuit_process_plain(
        ckt, params, vin, _state(ckt, b), input_node="Vin", return_state_seq=True)
    one = _host_forward(host_cxx(f"ts_2x{H}_one_thread", prog.host_source), prep, vin,
                        _state(ckt, b))
    np.testing.assert_allclose(one[0].numpy(), want.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(one[2].numpy(), torch.stack(want_seq).numpy(), atol=2e-5, rtol=0)
    cases = "".join(f"\n    case {k}:\n      lanes_run<{k}>(vin, z0, out, zf, seq, B, T, c, rows, "
                    f"times, w);\n      break;" for k in prog.lanes[1:])
    lib = host_lanes_cxx(f"ts_2x{H}_lanes", prog.step_source + prog.lanes_source
                         + LANE_GROUP_HARNESS
                         + LANE_STEP_HARNESS.format(cases=cases,
                                                    load=prog.emitter.lane_weights()[1]))
    S = len(prog.state_order)
    z0 = tfc._state_stack(prog, _state(ckt, b), vin)
    for K in prog.lanes[1:]:
        out, zf, seq = torch.empty(K, b, t), torch.empty(K, S, b), torch.empty(K, S, b, t)
        lib.circuit_lanes_host_run(K, vin.data_ptr(), z0.data_ptr(), out.data_ptr(),
                                   zf.data_ptr(), seq.data_ptr(), b, t, prep.vec.data_ptr(),
                                   prep.vec.data_ptr(), prep.vec.data_ptr(),
                                   prep.warr.data_ptr())
        for rank in range(K):
            assert torch.equal(out[rank], one[0]) and torch.equal(zf[rank], one[1]), (K, rank)
            assert torch.equal(seq[rank], one[2]), (K, rank)


def test_lane_counts_of_widths_no_k_divides():
    """A width that no K of LANES divides gets no lane form (the one-thread
    kernel alone, lanes = (1,)); a width that only 4 divides gets K = 4."""
    for H, want in ((3, ()), (6, ()), (2, ()), (12, (4,)), (32, (8, 16))):
        emitter = types.SimpleNamespace(H=H)
        assert cg._NeuralEmitter.lane_counts(emitter) == want, H
        every = cg._NeuralEmitter.lane_counts(emitter, every=True)
        assert every == tuple(k for k in cg.LANES if H % k == 0), H


def _plain_f_and_jacobian(ckt, prep, z, v):
    """f = F(z, v) and J[i][k] = dF_i/dz_k of the plain step at the points
    z (S lists of (n,)) by S forward-mode passes."""
    run = tfc.plain_step(ckt, prep)
    f, cols = None, []
    with fwAD.dual_level():
        for k in range(len(z)):
            dual = [fwAD.make_dual(x, torch.full_like(x, float(i == k))) for i, x in enumerate(z)]
            new, _ = run(dual, v, 0)
            parts = [fwAD.unpack_dual(x.expand_as(v)) for x in new]
            f = f or [p.primal.detach().clone() for p in parts]
            cols.append([torch.zeros_like(v) if p.tangent is None else p.tangent.clone()
                         for p in parts])
    return f, [[cols[k][i] for k in range(len(z))] for i in range(len(z))]


@pytest.mark.parametrize("name", ["ts", "ts_2x16", "hpf", "distilled"])
def test_host_compiled_deer_step_matches_plain_jacobian(host_cxx, name):
    """The generated DEER step (S forward-mode tangents of the traced step)
    writes f and the S x S Jacobian of the plain step, at the operating
    points of a plain forward run, perturbed."""
    ckt, params, node, amp = _case(name)
    vin = _vin(len(name) + 3, amp)
    _, _, seq = tfc.fused_circuit_process_plain(ckt, params, vin, _state(ckt), input_node=node,
                                                return_state_seq=True)
    rng = np.random.default_rng(11)
    z = [x.reshape(-1) + torch.from_numpy(0.01 * rng.standard_normal(B * T).astype(np.float32))
         for x in seq]
    v = vin.reshape(-1)
    prep = tfc.prepare(ckt, params, "cpu", input_node=node)
    deer = cg.deer_program(ckt, prep.prog)
    S = deer.n_state
    assert S == len(seq) and deer.ops_per_sample > 0 and "deer_cluster_kernel" in deer.source
    assert "deer_kernel" not in deer.host_source and '#include "deer_scan.cuh"' in deer.source
    assert deer is cg.deer_program(ckt, prep.prog)  # cached by structure
    lib = host_cxx(name + "_deer", deer.host_source)
    vp = ctypes.c_void_p
    lib.circuit_deer_host_run.argtypes = [vp] * 5 + [ctypes.c_int] + [vp] * 2
    n = v.numel()
    zs = torch.stack(z).contiguous()
    f, J, out = torch.empty(S, n), torch.empty(S * S, n), torch.empty(n)
    lib.circuit_deer_host_run(zs.data_ptr(), v.data_ptr(), f.data_ptr(), J.data_ptr(),
                              out.data_ptr(), n, prep.vec.data_ptr(), _ptr(prep.warr, prep.vec))
    want_f, want_J = _plain_f_and_jacobian(ckt, prep, z, v)
    for i in range(S):
        np.testing.assert_allclose(f[i].numpy(), want_f[i].numpy(), atol=2e-5, rtol=0)
        for k in range(S):
            assert _rel(J[i * S + k], want_J[i][k]) < 1e-4, (i, k)
    # the output is the forward step's
    run = tfc.plain_step(ckt, prep)
    _, y = run(z, v, 0)
    np.testing.assert_allclose(out.numpy(), y.numpy(), atol=2e-5, rtol=0)


def test_wright_omega_jvp_matches_jax_custom_jvp():
    """Forward mode through omega: the implicit derivative dx / (1 + 1/w),
    as the JAX package's custom_jvp (what the plain DEER Jacobian uses)."""
    import jax
    import jax.numpy as jnp

    from diffwdf_tpu.roots import omega as jomega
    from diffwdf_tpu_torch.roots.omega import wright_omega

    x = np.linspace(-30.0, 60.0, 513).astype(np.float32)
    dx = np.random.default_rng(0).standard_normal(x.shape).astype(np.float32)
    w_j, dw_j = jax.jvp(lambda t: jomega.wright_omega(t, 3), (jnp.asarray(x),),
                        (jnp.asarray(dx),))
    with fwAD.dual_level():
        out = fwAD.unpack_dual(wright_omega(fwAD.make_dual(torch.from_numpy(x),
                                                           torch.from_numpy(dx)), 3))
    np.testing.assert_allclose(out.primal.numpy(), np.asarray(w_j), rtol=5e-6, atol=0)
    np.testing.assert_allclose(out.tangent.numpy(), np.asarray(dw_j), rtol=5e-6, atol=1e-30)
    w, dw = torch.func.jvp(lambda t: wright_omega(t, 3), (torch.from_numpy(x),),
                           (torch.from_numpy(dx),))
    np.testing.assert_array_equal(dw.numpy(), out.tangent.numpy())


def test_root_without_tangent_and_pot_in_rtype_raise():
    """The distilled root has its tangent (the adjoint and DEER programs
    generate, counting its slope's operations); an MLP root outside the NxH
    family has none and raises in the words of JAX's refusals; a pot
    reaching an R-type's matrix raises."""
    root, rp = tdc.make_root_from_zoo(0, device="cpu")
    droot, _ = distill_root(root, rp, 1.0 / (1.0 / 47.0e3 + 2.0 * 2.2e-9 * FS))
    ckt = tdc.make_diode_clipper(droot, FS)
    prep = tfc.prepare(ckt, ckt.init_params("cpu"), "cpu", input_node="Vs")
    adj, deer = cg.adjoint_program(ckt, prep.prog), cg.deer_program(ckt, prep.prog)
    slope = prep.prog.emitter.slope_ops
    assert slope > prep.prog.emitter.ops and adj.jacobian_ops > slope
    assert deer.ops_per_sample > slope and "cheb_root_value_tangent" in deer.source
    relu = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8,
                           activations=("tanh", "relu", "tanh", ""))
    rck = tdc.make_diode_clipper(relu, FS)
    rprep = tfc.prepare(rck, {**rck.init_params("cpu"), **relu.init_params("cpu")}, "cpu",
                        input_node="Vs")
    for make in (cg.adjoint_program, cg.deer_program):
        with pytest.raises(ValueError, match="all-tanh hidden layers"):
            make(rck, rprep.prog)
    # a per-row value reaching a matrix coefficient (an R-type's S) is refused
    with pytest.raises(ValueError, match="matrix-valued"):
        cg._shape(torch.zeros(4, 4, 4), batch=4, time=16)
    assert cg._shape(torch.zeros(4), batch=4, time=16) == cg.ROW
    assert cg._shape(torch.zeros(4, 16), batch=4, time=16) == cg.TIME
    assert cg._shape(torch.zeros(4, 4)) == (4, 4)


def test_dual_symbols_emit_product_and_quotient_rules():
    tr = cg._Trace()
    one = tr.const(1.0)
    x = cg.Dual(cg.Sym(tr, "x"), (one, None))
    c = cg.Sym(tr, "c[0]")
    y = c * x + 2.0  # tangent: c along the first direction, none along the second
    assert y.d[0] is c and y.d[1] is None
    q = x / c
    lines, _ = tr.live(q.d[0].ref)
    assert lines[-1].endswith("= __fdiv_rn(1.0f, c[0]);")  # (dx - q dc) / c, dc = 0
    z = x * x  # 2 x dx
    lines, ops = tr.live(z.d[0].ref)
    assert ops == 1 and lines[-1].endswith("__fadd_rn(x, x);")


def test_two_drives_give_one_source():
    root, rp = tdc.make_root_from_zoo(0, device="cpu")
    progs, vecs = [], []
    for drive in (0.0, 1.0):
        ckt = tts.make_tube_screamer(root, FS, drive=drive)
        params = {**ckt.init_params("cpu"), **rp}
        prep = tfc.prepare(ckt, params, "cpu", input_node="Vin")
        progs.append(prep.prog)
        vecs.append(prep.vec)
    assert progs[0].source == progs[1].source
    assert _build.generated_path(progs[0].source) == _build.generated_path(progs[1].source)
    assert not torch.equal(vecs[0], vecs[1])  # the drive is an argument
    assert str(tts.drive_to_r6(1.0)) not in progs[0].source
    # a block-rate control moves the drive without a new source either
    ckt = tts.make_tube_screamer(root, FS, drive=0.5)
    params = {**ckt.init_params("cpu"), **rp}
    for r6 in (tts.drive_to_r6(0.0), tts.drive_to_r6(1.0)):
        static = {"R6": {"R": torch.tensor(r6)}}
        progs.append(tfc.prepare(ckt, params, "cpu", input_node="Vin",
                                 static_controls=static).prog)
    assert progs[2].source == progs[3].source
    # a per-row drive is another source, and two per-row drives are one
    for r6 in (tts.drive_to_r6(0.0), tts.drive_to_r6(1.0)):
        rows = {"R6": {"R": torch.full((4,), r6)}}
        progs.append(tfc.prepare(ckt, params, "cpu", input_node="Vin", row_controls=rows,
                                 shape=(4, 16)).prog)
    assert progs[4].source == progs[5].source != progs[2].source


def test_source_layout_and_operation_count():
    ckt, params, node, _ = _case("rc")
    prog, vec, warr, rows, times = tfc.prepare(ckt, params, "cpu", input_node=node)[:5]
    assert prog.state_order == (("C1", "z"),) and warr is None
    assert rows.numel() == times.numel() == 0
    # coeffs C1.R, I1.R, R1.R, S1.R, S1.p1R; params C1.C, R1.R
    assert [".".join(p) for p, _ in prog.layout] == [
        "coeffs.C1.R", "coeffs.I1.R", "coeffs.R1.R", "coeffs.S1.R", "coeffs.S1.p1R",
        "params.C1.C", "params.R1.R"]
    assert prog.n_coeffs == len(vec) == 7
    assert "float circuit_step(" in prog.step_source and "circuit_kernel" in prog.source
    assert "circuit_kernel" not in prog.host_source
    # reflected: negations only (the resistor's 0 folds away); root -a + 2 v
    # (2); incident p1R (x + z) and x + b1_down (3); the output (a + b) * 0.5
    # (2): 7 operations, negations free
    assert prog.ops_per_sample == 7, prog.step_source
    ts, tparams, _, _ = _case("ts")
    ts_prog, ts_vec = tfc.prepare(ts, tparams, "cpu", input_node="Vin")[:2]
    assert ts_prog.state_order == (("C2", "z"), ("C3", "z"), ("C4", "z"))
    assert ("coeffs", "R", "S") in dict(ts_prog.layout)
    assert dict(ts_prog.layout)[("coeffs", "R", "S")] == (4, 4)
    # the forward solves the diode pair with omega_pair (branch-free, the
    # lane form's omega); the adjoint keeps omega()
    assert ts_prog.n_coeffs == len(ts_vec) and "omega_pair<3>(" in ts_prog.step_source
    assert "omega(" not in ts_prog.step_source
    assert "omega(" in cg.adjoint_program(ts, ts_prog).source


def test_symbols_fold_zeros_and_ones():
    tr = cg._Trace()
    x, c = cg.Sym(tr, "x"), cg.Sym(tr, "c[0]")
    assert (0 + x) is x and (x - 0.0) is x and (x * 1.0) is x and (1 * x) is x
    assert (x * 0).value == 0.0 and (x.zeros_like() * c).value == 0.0
    assert tr.entries == []
    y = 2.0 * x - c / 4.0
    dead = x * c
    assert tr.live(y.ref) == (["const float t0 = __fmul_rn(2.0f, x);",
                               "const float t1 = __fdiv_rn(c[0], 4.0f);",
                               "const float t2 = __fsub_rn(t0, t1);"], 3)
    assert y.ref == "t2" and tr.live(dead.ref) == (["const float t3 = __fmul_rn(x, c[0]);"], 1)
    assert (-tr.const(0.5)).ref == "(-0.5f)"
    with pytest.raises(TypeError):
        x + "a"


class _Mystery(WDFNode):
    name = "M"

    def adapt(self, params, controls, coeffs, fs):
        coeffs[self.name] = {"R": torch.tensor(1.0)}
        return coeffs[self.name]["R"]


class _MysteryRoot(Root):
    name = "mystery"

    def reflect(self, a, R, params, controls):
        return a


def test_unknown_node_or_root_raises():
    ckt = Circuit(tree=_Mystery(), root=tdc.DiodePairRoot(name="dp"), fs=FS, outputs=("M",))
    params = {"dp": ckt.root.init_params("cpu")["dp"]}
    with pytest.raises(NotImplementedError, match="_Mystery"):
        tfc.fused_circuit_process_plain(ckt, params, torch.zeros(2, 4), {}, input_node="Vs")
    ckt = Circuit(tree=Resistor("R1"), root=_MysteryRoot(), fs=FS, outputs=("R1",))
    with pytest.raises(NotImplementedError, match="_MysteryRoot"):
        tfc.fused_circuit_process_plain(ckt, ckt.init_params("cpu"), torch.zeros(2, 4), {},
                                        input_node="Vs")
    ckt, params, node, _ = _case("rc")
    two = Circuit(tree=ckt.tree, root=ckt.root, fs=FS, outputs=("C1", "R1"))
    with pytest.raises(ValueError, match="one output probe"):
        tfc.fused_circuit_process_plain(two, params, torch.zeros(2, 4), _state(two),
                                        input_node=node)


def test_generated_build_caches_by_source(tmp_path, monkeypatch):
    """The build path with a stand-in compiler: one nvcc per new source,
    none for a source already built, the .cu kept beside the library, and
    a failed compile raising with its log."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    "for a; do last=$a; done\n"
                    "if grep -q COMPILE_ERROR \"$last\"; then echo 'error: bad' >&2; exit 1; fi\n"
                    "while [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then out=$2; fi; shift; done\n"
                    "echo 'ptxas info    : Used 40 registers'\n"
                    "touch \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.build_generated, "builds", 0)
    paths = _build.build_generated(["// a\n", "// b\n", "// a\n"])
    assert paths[0] == paths[2] != paths[1] and all(p.exists() for p in paths)
    assert _build.build_generated.builds == 2
    assert paths[0].with_suffix(".cu").read_text() == "// a\n"
    assert "registers" in paths[0].with_suffix(".log").read_text()
    _build.build_generated(["// b\n"])
    assert _build.build_generated.builds == 2
    with pytest.raises(RuntimeError, match="error: bad"):
        _build.build_generated(["// COMPILE_ERROR\n"])
    assert not _build.generated_path("// COMPILE_ERROR\n").exists()


# ---------------------------------------------------------------------------
# The diode pair's lane form (B7 analytic): its two omega solves on a pair
# of lanes (csrc/omega_lanes.cuh), the tree on both
# ---------------------------------------------------------------------------


def _pair_case(name):
    """(JAX circuit, port circuit, input node, amplitude) of an analytic
    root served through B7: the LPF clipper, the HPF clipper with the TOMS
    ("best") and approx ("low") roots, the Tube Screamer with both."""
    import diffwdf_tpu as dwdf
    from diffwdf_tpu.models import diode_clipper as jdc
    from diffwdf_tpu.models import tube_screamer as jts

    quality = "low" if name.endswith("_low") else "best"
    jroot = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d, quality=quality)
    troot = tdc.DiodePairRoot(name="dp", diode=diode_1n4148_1u1d, quality=quality)
    if name.startswith("ts"):
        return (jts.make_tube_screamer(jroot, FS, drive=0.5),
                tts.make_tube_screamer(troot, FS, drive=0.5), "Vin", 0.2)
    if name.startswith("hpf"):
        return jdc.make_hpf_diode_clipper(jroot, FS), tdc.make_hpf_diode_clipper(troot, FS), \
            "Vs", 1.5
    return jdc.make_diode_clipper(jroot, FS), tdc.make_diode_clipper(troot, FS), "Vs", 1.5


def _pair_lanes(host_lanes_cxx, name, prog, prep, vin, state):
    """(out (2, b, T), z_final (2, S, b), trajectory (2, S, b, T)) of the
    generated lane form on a pair of host threads per stream."""
    b, t = vin.shape
    assert prog.lanes == (1, 2) and "omega_pair_lanes<" in prog.lanes_source
    cases = "\n    case 2:\n      lanes_run<2>(vin, z0, out, zf, seq, B, T, c, rows, times, w);\n      break;"
    lib = host_lanes_cxx(name, prog.step_source + prog.lanes_source + LANE_GROUP_HARNESS
                         + LANE_STEP_HARNESS.format(cases=cases, load=prog.emitter.lane_weights()[1]))
    S = len(prog.state_order)
    z0 = tfc._state_stack(prog, state, vin)
    out, zf, seq = torch.empty(2, b, t), torch.empty(2, S, b), torch.empty(2, S, b, t)
    lib.circuit_lanes_host_run(2, vin.data_ptr(), z0.data_ptr(), out.data_ptr(), zf.data_ptr(),
                               seq.data_ptr(), b, t, prep.vec.data_ptr(),
                               _ptr(prep.rows, prep.vec), _ptr(prep.times, prep.vec),
                               _ptr(prep.warr, prep.vec))
    return out, zf, seq


@pytest.mark.parametrize("name", ["lpf", "hpf", "hpf_low", "ts", "ts_low"])
def test_host_pair_step_matches_one_thread_step_and_jax(host_cxx, host_lanes_cxx, name):
    """The diode pair's lane form on two host threads a stream: both lanes
    end every step with the one-thread step's bits (output, final state,
    trajectory); the one-thread step lies within the JAX suite's 2e-5 of
    JAX's fused_circuit_process in interpret mode (tests/test_fused_circuit.py:55)
    at its tile of 1,024 streams, output and final state."""
    import jax
    import jax.numpy as jnp

    from diffwdf_tpu.ops import fused_circuit as jfc
    from diffwdf_tpu_torch.nn.convert import params_from_jax

    jckt, ckt, node, amp = _pair_case(name)
    jparams = {**jckt.init_params(), **jckt.root.init_params()}
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    b, t = 1024, 64
    rng = np.random.default_rng(len(name) + 30)
    x = amp * np.sin(2 * np.pi * 1000.0 * np.arange(t) / FS)[None, :] * np.ones((b, 1))
    vin = torch.from_numpy((x + 0.1 * rng.standard_normal((b, t))).astype(np.float32))
    prep = tfc.prepare(ckt, params, "cpu", input_node=node)
    one = _host_forward(host_cxx(name + "_pair_one", prep.prog.host_source), prep, vin,
                        _state(ckt, b))
    want, want_state = jfc.fused_circuit_process(
        jckt, jparams, jnp.asarray(vin.numpy()),
        jax.tree_util.tree_map(lambda z: jnp.zeros((b,), jnp.float32), jckt.init_state()),
        input_node=node, interpret=True)
    np.testing.assert_allclose(one[0].numpy(), np.asarray(want), atol=2e-5, rtol=0)
    for k, (n, f) in enumerate(prep.prog.state_order):
        np.testing.assert_allclose(one[1][k].numpy(), np.asarray(want_state[n][f]), atol=2e-5,
                                   rtol=0)
    rows = 6  # the lane form on the first rows
    lanes = _pair_lanes(host_lanes_cxx, name + "_pair_lanes", prep.prog, prep,
                        vin[:rows].contiguous(), _state(ckt, rows))
    for rank in range(2):
        assert torch.equal(lanes[0][rank], one[0][:rows]), rank
        assert torch.equal(lanes[1][rank], one[1][:, :rows]), rank
        assert torch.equal(lanes[2][rank], one[2][:, :rows]), rank


def _pair_pot_case(name):
    """(circuit, params, input node, amplitude, row controls) of the diode
    pair with a pot: the training clipper with one source R per row
    (r_kind "row") and per sample ("time": the root's two logs in the step),
    the Tube Screamer with its drive per sample (time slots in the tree and
    at the root)."""
    if name in ("ts_sample", "clipper_sample"):
        return _pot_case(name)
    rng = np.random.default_rng(12)
    root = tdc.DiodePairRoot(name="dp", diode=diode_1n4148_1u1d)
    ckt = tdc.make_training_clipper(root, FS)
    r = np.exp(rng.uniform(np.log(36e3), np.log(73e3), B)).astype(np.float32)
    return (ckt, {**ckt.init_params("cpu"), **root.init_params("cpu")}, "Vs", 1.5,
            {"Vs": {"R": torch.from_numpy(r)}})


@pytest.mark.parametrize("name,r_kind", [("clipper_row", "row"), ("clipper_sample", "time"),
                                         ("ts_sample", "time")])
def test_host_pair_step_with_pots_matches_one_thread_step(host_cxx, host_lanes_cxx, name,
                                                          r_kind):
    """The lane form with a per-row R at the root and a per-sample R (the two
    logs taken in the step on both lanes; the Tube Screamer's drive also in
    the tree):
    both lanes have the one-thread step's bits, trajectory included, and the
    one-thread step lies within 2e-5 of the plain version."""
    ckt, params, node, amp, rows = _pair_pot_case(name)
    vin = _vin(len(name) + 40, amp)
    prep = tfc.prepare(ckt, params, "cpu", input_node=node, row_controls=rows, shape=(B, T))
    assert prep.prog.emitter.r_kind == r_kind
    one = _host_forward(host_cxx(name + "_pair_pot_one", prep.prog.host_source), prep, vin,
                        _state(ckt))
    want, _, want_seq = tfc.fused_circuit_process_plain(
        ckt, params, vin, _state(ckt), input_node=node, row_controls=rows, return_state_seq=True)
    np.testing.assert_allclose(one[0].numpy(), want.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(one[2].numpy(), torch.stack(want_seq).numpy(), atol=2e-5, rtol=0)
    lanes = _pair_lanes(host_lanes_cxx, name + "_pair_pot_lanes", prep.prog, prep, vin,
                        _state(ckt))
    for rank in range(2):
        assert torch.equal(lanes[0][rank], one[0]) and torch.equal(lanes[1][rank], one[1]), rank
        assert torch.equal(lanes[2][rank], one[2]), rank


@pytest.mark.parametrize("name", ["ts", "ts_2x16", "clipper_sample"])
def test_lane_tree_check_refuses_an_altered_tree_line(name):
    """_lanes_parts holds every line of the lane form that is not the root's
    own to the one-thread step's: a step whose tree differs in one operation
    is refused (AssertionError), one whose root line differs is not (the
    root's lines are the emitter's, ``own_line``)."""
    ckt, params, node, _, rows = (_pot_case(name) if name == "clipper_sample"
                                  else (*_case(name), None))
    prep = tfc.prepare(ckt, params, "cpu", input_node=node, row_controls=rows, shape=(B, T))
    prog, emitter = prep.prog, prep.prog.emitter
    body = cg._trace_forward(ckt, prog.layout, node, emitter)[0]
    sizes = (max(len(prog.state_order), 1), max(prog.n_coeffs, 1), max(prog.n_rows, 1),
             max(prog.n_times, 1), max(emitter.n_keep, 1))
    ks = emitter.lane_counts()
    assert ks and cg._lanes_parts(ckt, prog.layout, node, emitter, body, ks, sizes, 128)
    lines = body.splitlines()
    tree = next(i for i, line in enumerate(lines)
                if "__fadd_rn(" in line and not emitter.own_line(line))
    own = next(i for i, line in enumerate(lines)
               if emitter.own_line(line) and not line.strip().startswith("//"))
    altered = lines[:tree] + [lines[tree].replace("__fadd_rn(", "__fsub_rn(", 1)] + lines[tree + 1:]
    with pytest.raises(AssertionError, match="tree differs"):
        cg._lanes_parts(ckt, prog.layout, node, emitter, "\n".join(altered), ks, sizes, 128)
    root_only = lines[:own] + [lines[own] + "  // another root line"] + lines[own + 1:]
    assert cg._lanes_parts(ckt, prog.layout, node, emitter, "\n".join(root_only), ks, sizes, 128)


OMEGA_FORMS_HARNESS = """
#include "omega.cuh"

// omega() with its middle-region polynomial written as nvcc contracts it
// (the fmaf form of omega_guess): the host compiler does not contract
static float omega_contracted(float x, int iters) {
  float u;
  if (x <= -1.f) {
    u = x - expf(x);
  } else if (x >= 2.f) {
    const float lx = logf(x);
    u = logf(x - lx + lx / x);
  } else {
    const float t = x - 1.f;
    u = logf(fmaf(0.0625f * t, t, fmaf(0.5f, t, 1.f)));
  }
  for (int k = 0; k < iters; ++k) u = omega_newton_step(x, u);
  return expf(u);
}

template <int ITERS>
static void forms(const float* x, int n, float* w_omega, float* w_select, float* w_contracted) {
  for (int i = 0; i < n; ++i) {
    w_omega[i] = omega(x[i], ITERS);
    w_select[i] = omega_select<ITERS>(x[i]);
    w_contracted[i] = omega_contracted(x[i], ITERS);
  }
}

extern "C" void omega_forms_host(const float* x, int n, int iters, float* a, float* b, float* c) {
  switch (iters) {
    case 1: forms<1>(x, n, a, b, c); break;
    case 2: forms<2>(x, n, a, b, c); break;
    case 3: forms<3>(x, n, a, b, c); break;
  }
}
"""


@pytest.mark.parametrize("iters", [1, 2, 3])
def test_omega_select_against_omega_on_host(host_cxx, iters):
    """omega_select<ITERS> (the generated forward's omega) against omega()
    on the host, over a grid that crosses the region edges -1 and 2 and
    reaches both tails, at the zoo's Newton counts (3 "best", 2, 1 "low").
    Outside (-1, 2) the two are the same operations: the same bits.  Inside,
    omega_select's guess is the polynomial as nvcc contracts omega()'s
    (fmaf): it has the bits of omega() written so, while the host's omega(),
    which the host compiler does not contract, rounds the polynomial twice
    and may differ in the last bits (within 4e-7 relative).  On the card the
    two agree everywhere (tests/test_torch_gpu.py, chip_smoke.py), so one
    omega serves the generated forward's one-thread step and lane form."""
    lib = host_cxx("omega_forms", OMEGA_FORMS_HARNESS)
    vp = ctypes.c_void_p
    lib.omega_forms_host.argtypes = [vp, ctypes.c_int, ctypes.c_int, vp, vp, vp]
    x = np.concatenate([np.linspace(-120.0, 200.0, 400_001), np.linspace(-1.5, 2.5, 400_001),
                        [-1.0, 2.0, np.nextafter(np.float32(-1.0), np.float32(0.0)),
                         np.nextafter(np.float32(2.0), np.float32(0.0)), 0.0, -1e30, 1e30]])
    x = np.ascontiguousarray(x.astype(np.float32))
    w = [np.empty_like(x) for _ in range(3)]
    lib.omega_forms_host(x.ctypes.data, x.size, iters, *(a.ctypes.data for a in w))
    w_omega, w_select, w_contracted = w
    assert np.isfinite(w_select[:-2]).all()
    outside = (x <= -1.0) | (x >= 2.0)
    assert np.array_equal(w_omega[outside].view(np.uint32), w_select[outside].view(np.uint32))
    assert np.array_equal(w_contracted.view(np.uint32), w_select.view(np.uint32))
    inside = ~outside
    rel = np.abs(w_omega[inside] - w_select[inside]) / np.abs(w_select[inside])
    assert rel.max() <= 4e-7, rel.max()
