"""The port's serving artifacts (``runtime/artifact.py``, ``torch.export``)
and the custom ops they hold (``ops/registry.py``), on the CPU.

Counterpart of ``tests/test_artifact.py`` at its budgets: a loaded
artifact within 1e-5 of the scan engine (the JAX package's and the
port's, on the same seeded inputs) for the analytic LPF clipper (B2's op),
the pretrained 2x16 (B1's op) and the Tube Screamer (B7's op, the generated
forward built for the host), and within 1e-5 of the JAX package's own
artifact (``save_artifact`` / ``load_artifact``) for the same circuit and
input; chunked serving equals one-shot serving; loading needs no circuit;
a file of another format, the JAX package's ``.npz`` among them, is
refused by name, as is ``device="cuda"`` with no card; a relu MLP root is
exported through B7's general MLP root and served within 1e-5 of the JAX
package's artifact.  The ops on CPU tensors give the bits of the wrappers' plain
versions (B7: of its host build), count no launch, and pass
``torch.library.opcheck``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffwdf_tpu.models.diode_clipper import make_diode_clipper as j_make_clipper
from diffwdf_tpu.models.diode_clipper import make_root_from_zoo as j_zoo
from diffwdf_tpu.models.tube_screamer import make_tube_screamer as j_make_ts
from diffwdf_tpu.roots.diode import DiodePairRoot as JDiodePairRoot
from diffwdf_tpu.roots.neural import NeuralDiodeRoot as JNeuralDiodeRoot
from diffwdf_tpu.runtime import artifact as jart
from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper, make_root_from_zoo
from diffwdf_tpu_torch.models.tube_screamer import make_tube_screamer
from diffwdf_tpu_torch.ops import fused_circuit as fcirc
from diffwdf_tpu_torch.ops import fused_clipper as fc
from diffwdf_tpu_torch.ops import registry
from diffwdf_tpu_torch.roots.diode import DiodePairRoot
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot
from diffwdf_tpu_torch.runtime.artifact import FORMAT, load_artifact, save_artifact
from diffwdf_tpu_torch.runtime.stream import _generic_exact_runner, _lpf_exact_runner

FS = 48000.0
PRETRAINED_2x16 = "models/pretrained/1N4148 (1U-1D)_2x16_pretrained_model.json"
BUDGET = 1e-5  # tests/test_artifact.py:46


def _sine(n, amp=2.0, f=220.0):
    return (amp * np.sin(2 * np.pi * f * np.arange(n) / FS)).astype(np.float32)


def _case(name):
    """(port circuit, port params, JAX circuit, JAX params, input node, amp)."""
    if name == "ts":
        root, jroot = DiodePairRoot(name="dp"), JDiodePairRoot(name="dp")
        ckt, jckt = make_tube_screamer(root, FS, drive=0.5), j_make_ts(jroot, FS, drive=0.5)
        return (ckt, {**ckt.init_params("cpu"), **root.init_params("cpu")}, jckt,
                {**jckt.init_params(), **jroot.init_params()}, "Vin", 0.5)
    index = {"analytic": 0, "neural": 4}[name]
    root, frag = make_root_from_zoo(index, device="cpu")
    jroot, jfrag = j_zoo(index, json_path=PRETRAINED_2x16 if index == 4 else None)
    ckt, jckt = make_diode_clipper(root, FS), j_make_clipper(jroot, FS)
    return (ckt, {**ckt.init_params("cpu"), **frag}, jckt, {**jckt.init_params(), **jfrag},
            "Vs", 2.0)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """name -> (artifact path, case), block_len 256."""
    out = {}
    for name in ("analytic", "neural", "ts"):
        case = _case(name)
        path = str(tmp_path_factory.mktemp("art") / f"{name}.pt2")
        save_artifact(path, case[0], case[1], input_node=case[4], block_len=256, fs=FS)
        out[name] = (path, case)
    return out


@pytest.mark.parametrize("name,kernel", [("analytic", "B2 clipper_analytic"),
                                         ("neural", "B1 clipper_neural"),
                                         ("ts", "B7 circuit_forward")])
def test_artifact_roundtrip_matches_scan(saved, name, kernel):
    path, (ckt, params, jckt, jparams, node, amp) = saved[name]
    art = load_artifact(path, device="cpu")
    assert art.meta["format"] == FORMAT and art.meta["kernel"] == kernel
    x = _sine(1000, amp)  # no multiple of block_len: exercises padding
    y = art.run(x)
    ref, _ = ckt.process(params, ckt.init_state("cpu"), {node: {"v": torch.from_numpy(x)}})
    jref, _ = jckt.process(jparams, jckt.init_state(), {node: {"v": jnp.asarray(x)}})
    assert y.shape == (1000,) and y.dtype == np.float32
    assert np.max(np.abs(y - ref.numpy())) < BUDGET
    assert np.max(np.abs(y - np.asarray(jref))) < BUDGET


@pytest.mark.parametrize("name", ["analytic", "neural", "ts"])
def test_artifact_matches_jax_artifact(saved, tmp_path, name):
    """The same circuit and input through the JAX package's artifact."""
    path, (_, _, jckt, jparams, node, amp) = saved[name]
    jpath = str(tmp_path / "j.npz")
    jart.save_artifact(jpath, jckt, jparams, input_node=node, block_len=256, fs=FS,
                       platforms=("cpu",))
    x = _sine(700, amp, f=330.0)
    want = jart.load_artifact(jpath).run(x)
    got = load_artifact(path, device="cpu").run(x)
    assert np.max(np.abs(got - want)) < BUDGET


@pytest.mark.parametrize("name", ["analytic", "ts"])
def test_artifact_state_carries_across_blocks(saved, name):
    """Chunked serving is gap-free: state crosses block boundaries exactly."""
    path, (*_, amp) = saved[name]
    art = load_artifact(path, device="cpu")
    x = _sine(1024, amp)
    y_stream = art.run(x)
    state, y_manual = art.init_state, []
    for i in range(0, 1024, 256):
        out, state = art.process(state, x[i: i + 256])
        y_manual.append(out.numpy())
    assert np.array_equal(y_stream, np.concatenate(y_manual))


@pytest.mark.parametrize("name", ["analytic", "neural", "ts"])
def test_artifact_blocks_equal_the_exact_runner(saved, name):
    """Each block is the stream's exact runner's block (the same kernel
    wrapper on the same arguments): B2's and B1's plain versions, B7's
    host build against the plain version within 2e-5."""
    path, (ckt, params, _, _, node, amp) = saved[name]
    art = load_artifact(path, device="cpu")
    run = _lpf_exact_runner(ckt) if node == "Vs" else _generic_exact_runner(ckt, node)
    x = _sine(512, amp)
    state, st = art.init_state, ckt.init_state("cpu")
    for i in range(0, 512, 256):
        v = torch.from_numpy(x[i: i + 256])
        y, state = art.process(state, v)
        want, st = run(params, st, {node: {"v": v}}, {})
        if name == "ts":
            assert torch.max(torch.abs(y - want)) < 2e-5
        else:
            assert torch.equal(y, want)


def test_artifact_is_self_contained(tmp_path):
    ckt, params, *_ = _case("analytic")
    path = str(tmp_path / "clip.pt2")
    save_artifact(path, ckt, params, block_len=64, fs=FS)
    del ckt, params
    art = load_artifact(path, device="cpu")
    assert art.block_len == 64 and len(art.init_state) == art.meta["n_state"] == 1
    assert art.meta["state_order"] == [["C", "z"]] and art.device == torch.device("cpu")
    y = art.run(_sine(200))
    assert y.shape == (200,) and np.all(np.isfinite(y)) and np.max(np.abs(y)) > 0.1


def test_artifact_static_controls_are_baked_in(tmp_path):
    """A static source R (the CLI's --cutoff) is a constant of the program."""
    ckt, params, *_ = _case("analytic")
    path = str(tmp_path / "r.pt2")
    save_artifact(path, ckt, params, block_len=256, fs=FS,
                  static_controls={"Vs": {"R": 5.0e3}})
    x = _sine(512)
    ref, _ = ckt.process(params, ckt.init_state("cpu"), {"Vs": {"v": torch.from_numpy(x)}},
                         static_controls={"Vs": {"R": 5.0e3}})
    y = load_artifact(path, device="cpu").run(x)
    assert np.max(np.abs(y - ref.numpy())) < BUDGET


def test_artifact_rejects_foreign_files(tmp_path):
    junk = str(tmp_path / "junk.npz")
    np.savez(junk, meta=np.asarray('{"format": "other"}'))
    with pytest.raises(ValueError, match=FORMAT):
        load_artifact(junk, device="cpu")
    text = tmp_path / "text.pt2"
    text.write_text("not an archive")
    with pytest.raises(ValueError, match=FORMAT):
        load_artifact(str(text), device="cpu")
    jroot = JDiodePairRoot(name="dp")
    jckt = j_make_clipper(jroot, FS)
    jpath = str(tmp_path / "jax.npz")
    jart.save_artifact(jpath, jckt, {**jckt.init_params(), **jroot.init_params()},
                       block_len=64, platforms=("cpu",))
    with pytest.raises(ValueError, match="diffwdf-artifact-v1 file"):
        load_artifact(jpath, device="cpu")


def test_artifact_refuses_a_root_no_kernel_takes(tmp_path):
    """An MLP root outside the NxH family (relu layers), which no kernel
    took before the general MLP root of B7's generated forward: exported
    through B7's op and served (its host build here) within 1e-5 of the
    JAX package's artifact of the same root (its scan) and of
    Circuit.process."""
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8,
                           activations=("relu", "relu", "relu", ""))
    ckt = make_diode_clipper(root, FS)
    params = {**ckt.init_params("cpu"), **root.init_params("cpu")}
    path = str(tmp_path / "relu.pt2")
    meta = save_artifact(path, ckt, params, block_len=256, fs=FS)
    assert meta["kernel"] == "B7 circuit_forward"
    jroot = JNeuralDiodeRoot(name="dp", n_layers=2, layer_size=8, activations=root.activations)
    jckt = j_make_clipper(jroot, FS)
    jmlp = {"layers": [{k: jnp.asarray(v.numpy()) for k, v in l.items()}
                       for l in params["dp"]["layers"]]}
    jpath = str(tmp_path / "relu.npz")
    jart.save_artifact(jpath, jckt, {**jckt.init_params(), "dp": jmlp}, block_len=256, fs=FS,
                       platforms=("cpu",))
    x = _sine(700, 2.0, f=330.0)
    got = load_artifact(path, device="cpu").run(x)
    ref, _ = ckt.process(params, ckt.init_state("cpu"), {"Vs": {"v": torch.from_numpy(x)}})
    assert np.max(np.abs(got - jart.load_artifact(jpath).run(x))) < BUDGET
    assert np.max(np.abs(got - ref.numpy())) < BUDGET


def test_load_artifact_cuda_without_a_card_raises(saved):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_artifact(saved["analytic"][0])


def _op_inputs():
    gen = torch.Generator().manual_seed(3)
    vin = 2.0 * torch.randn(3, 200, generator=gen)
    z0 = 0.1 * torch.randn(3, generator=gen)
    return vin, z0


def _wrapper_launches():
    return (fc.fused_clipper_analytic.launches, fc.fused_clipper_neural.launches,
            fcirc.fused_circuit_process.launches)


def test_ops_on_cpu_give_the_wrappers_bits():
    vin, z0 = _op_inputs()
    before = _wrapper_launches()
    d = DiodePairRoot(name="dp").diode
    args = (47e3, 2.2e-9, d.Is, d.Vt * d.nabla, d.N_up, d.N_down)
    got = registry.clipper_analytic(vin, z0, *args, FS, 3)
    want = fc.fused_clipper_analytic(vin, z0, *args, fs=FS, quality_iters=3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    _, frag = make_root_from_zoo(4, device="cpu")
    mlp = frag["dp"]
    got = torch.ops.diffwdf_torch.clipper_neural(vin, z0, registry.mlp_layers(mlp), 47e3,
                                                 2.2e-9, FS)
    want = fc.fused_clipper_neural(vin, z0, mlp, 47e3, 2.2e-9, fs=FS)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    ckt, params, *_ = _case("ts")
    prep = fcirc.prepare(ckt, params, "cpu", input_node="Vin")
    zs = torch.zeros(3, 3)
    got = registry.circuit_forward(prep.prog.source, prep.prog.host_source, 0.3 * vin, zs,
                                   prep.vec, prep.rows, prep.times, prep.warr, 2)
    want = registry.host_run(prep.prog.host_source, 0.3 * vin, zs, prep.vec, prep.rows,
                             prep.times, prep.warr)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    st = {k: {f: torch.zeros(3) for f in dd} for k, dd in ckt.init_state("cpu").items()}
    plain, _ = fcirc.fused_circuit_process(ckt, params, 0.3 * vin, st, input_node="Vin")
    assert torch.max(torch.abs(got[0] - plain)) < 2e-5
    assert _wrapper_launches() == before  # a CPU tensor launches nothing


def test_ops_pass_opcheck():
    vin, z0 = _op_inputs()
    d = DiodePairRoot(name="dp").diode
    torch.library.opcheck(registry.clipper_analytic,
                          (vin, z0, 47e3, 2.2e-9, d.Is, d.Vt * d.nabla, 1.0, 1.0, FS, 2))
    _, frag = make_root_from_zoo(2, device="cpu")
    torch.library.opcheck(registry.clipper_neural,
                          (vin, z0, registry.mlp_layers(frag["dp"]), 47e3, 2.2e-9, FS))
    ckt, params, *_ = _case("ts")
    prep = fcirc.prepare(ckt, params, "cpu", input_node="Vin")
    torch.library.opcheck(registry.circuit_forward,
                          (prep.prog.source, prep.prog.host_source, 0.3 * vin, torch.zeros(3, 3),
                           prep.vec, prep.rows, prep.times, prep.warr, 2))


def test_cli_export_then_run_artifact(tmp_path, capsys):
    """The deploy loop through the command line, against the JAX package's
    (the same arguments; ``--device cpu`` for the port)."""
    import json

    from diffwdf_tpu.cli import main as jmain
    from diffwdf_tpu_torch.cli import main

    inp = str(tmp_path / "x.npy")
    np.save(inp, _sine(700, amp=0.8))
    outs = {}
    for pkg, run, ext in (("port", lambda a: main(["--device", "cpu", *a]), "pt2"),
                          ("jax", jmain, "npz")):
        art, out = str(tmp_path / f"a_{pkg}.{ext}"), str(tmp_path / f"y_{pkg}.npy")
        run(["export-artifact", "--circuit", "clipper", "--model", "0", "--block", "256",
             "--out", art, "--check"])
        rec = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert rec["block_len"] == 256 and rec["n_state"] == 1
        assert rec["check_max_abs_err"] < BUDGET
        run(["run-artifact", "--artifact", art, "--input", inp, "--out", out])
        rec = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert rec["samples"] == 700 and rec["block_len"] == 256
        outs[pkg] = np.load(out)
    assert rec.get("device") is None  # the JAX line has no device key
    assert outs["port"].shape == (700,) and np.max(np.abs(outs["port"])) > 0.05
    assert np.max(np.abs(outs["port"] - outs["jax"])) < BUDGET
