"""diffwdf_tpu_torch generic fused circuit vs the JAX package.

The port's ``fused_circuit_process`` on the CPU runs its plain version (the
hoisted adaptation, then the circuit's step per sample on the kernel's f32
coefficient vector).  Each circuit is built in both packages; parameters
cross with ``params_from_jax``, a distilled root with
``cheb_root_from_jax``, neural roots as the same JAX-initialised or
checked-in weights.  The JAX side is ``fused_circuit_process`` (or
``_neural``) in interpret mode, as tests/test_fused_circuit.py runs it, at
B=1024 (its tile) and T=256, and with per-row and per-sample pots and the
state trajectory at T=24.  Budgets: the JAX suite's 2e-5 kernel-vs-scan
(``tests/test_fused_circuit.py:55-118``) on the output and the final state;
two half blocks against one block 1e-6 (``:100``).  The generated CUDA
kernel runs only on a card (tests/test_torch_gpu.py); its step is compiled
for the host in tests/test_torch_codegen.py.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffwdf_tpu as dwdf
from diffwdf_tpu.models import diode_clipper as jdc
from diffwdf_tpu.models import simple_circuits as jsc
from diffwdf_tpu.models import tube_screamer as jts
from diffwdf_tpu.ops import fused_circuit as jfc
from diffwdf_tpu.roots.distilled import distill_root as jax_distill_root
from diffwdf_tpu.roots.neural import NeuralDiodeRoot as JaxNeuralDiodeRoot
from diffwdf_tpu_torch.models import diode_clipper as tdc
from diffwdf_tpu_torch.models import simple_circuits as tsc
from diffwdf_tpu_torch.models import tube_screamer as tts
from diffwdf_tpu_torch.nn.convert import cheb_root_from_jax, params_from_jax
from diffwdf_tpu_torch.ops import fused_circuit as tfc
from diffwdf_tpu_torch.roots.diode import DiodePairRoot, diode_1n4148_1u1d
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot

REPO = Path(__file__).resolve().parents[1]
FS = 96000.0
B, T = 1024, 256


def _vin(seed=0, amp=1.5, b=B, t=T):
    """The JAX suite's input: amp sin(1 kHz) on every row plus 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    n = np.arange(t)
    x = amp * np.sin(2 * np.pi * 1000.0 * n / FS)[None, :] * np.ones((b, 1))
    return (x + 0.1 * rng.standard_normal((b, t))).astype(np.float32)


def _to_port(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _jax_diode():
    return dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)


def _port_diode():
    return DiodePairRoot(name="dp", diode=diode_1n4148_1u1d)


def _case(name):
    """(JAX circuit, port circuit, input node, amplitude, seed, the JAX
    neural MLP served through ``_neural`` or None)."""
    if name == "lpf":
        return jdc.make_diode_clipper(_jax_diode(), FS), tdc.make_diode_clipper(
            _port_diode(), FS), "Vs", 1.5, 0, None
    if name == "hpf":
        return jdc.make_hpf_diode_clipper(_jax_diode(), FS), tdc.make_hpf_diode_clipper(
            _port_diode(), FS), "Vs", 1.5, 1, None
    if name == "hpf_zoo3":  # the HPF-trained 2x16, the checked-in JSON in both
        jroot, frag = jdc.make_hpf_root_from_zoo(3)
        troot, _ = tdc.make_hpf_root_from_zoo(3, device="cpu")
        return (jdc.make_hpf_diode_clipper(jroot, FS), tdc.make_hpf_diode_clipper(troot, FS),
                "Vs", 1.5, 5, frag["dp"])
    if name == "ts":
        return (jts.make_tube_screamer(_jax_diode(), FS, drive=0.5),
                tts.make_tube_screamer(_port_diode(), FS, drive=0.5), "Vin", 0.2, 2, None)
    if name == "ts_2x16":  # tests/test_fused_circuit.py's random-init 2x16
        jroot = JaxNeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
        frag = jroot.init_params(jax.random.PRNGKey(3))
        troot = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
        return (jts.make_tube_screamer(jroot, FS, drive=0.5),
                tts.make_tube_screamer(troot, FS, drive=0.5), "Vin", 0.2, 4, frag["dp"])
    if name == "ts_zoo4":  # the pretrained 2x16
        jroot, frag = jdc.make_root_from_zoo(4)
        troot, _ = tdc.make_root_from_zoo(4, device="cpu")
        return (jts.make_tube_screamer(jroot, FS, drive=0.8),
                tts.make_tube_screamer(troot, FS, drive=0.8), "Vin", 0.2, 6, frag["dp"])
    if name == "lpf_distilled":
        r_port = 1.0 / (1.0 / 47.0e3 + 2.0 * 2.2e-9 * FS)
        jroot, _ = jax_distill_root(_jax_diode(), _jax_diode().init_params(), r_port)
        return (jdc.make_diode_clipper(jroot, FS),
                tdc.make_diode_clipper(cheb_root_from_jax(jroot), FS), "Vs", 1.5, 7, None)
    makers = {"rc": (jsc.make_rc_lowpass, tsc.make_rc_lowpass),
              "rl": (jsc.make_rl_highpass, tsc.make_rl_highpass),
              "divider": (jsc.make_voltage_divider, tsc.make_voltage_divider)}
    jmake, tmake = makers[name]
    return jmake(FS), tmake(FS), "Vs", 1.0, 3, None


def _jax_run(jckt, jparams, mlp, vin, node, state=None):
    state = state if state is not None else jax.tree_util.tree_map(
        lambda z: jnp.zeros((vin.shape[0],), jnp.float32), jckt.init_state())
    if mlp is None:
        return jfc.fused_circuit_process(jckt, jparams, jnp.asarray(vin), state,
                                         input_node=node, interpret=True)
    return jfc.fused_circuit_process_neural(jckt, jparams, mlp, jnp.asarray(vin), state,
                                            input_node=node, interpret=True)


def _port_state(tckt, b):
    return {k: {f: torch.zeros(b) for f in d} for k, d in tckt.init_state("cpu").items()}


def _port_run(tckt, tparams, mlp, vin, node, state=None, plain=True):
    vin = torch.from_numpy(vin)
    state = state if state is not None else _port_state(tckt, vin.shape[0])
    if mlp is None:
        fn = tfc.fused_circuit_process_plain if plain else tfc.fused_circuit_process
        return fn(tckt, tparams, vin, state, input_node=node)
    fn = tfc.fused_circuit_process_neural_plain if plain else tfc.fused_circuit_process_neural
    return fn(tckt, tparams, _to_port(mlp), vin, state, input_node=node)


CASES = ["lpf", "hpf", "hpf_zoo3", "ts", "ts_2x16", "ts_zoo4", "lpf_distilled", "rc", "rl",
         "divider"]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_kernel(name):
    jckt, tckt, node, amp, seed, mlp = _case(name)
    jparams = {**jckt.init_params(), **jckt.root.init_params()}
    if mlp is not None:
        jparams = {**jckt.init_params(), "dp": mlp}
    vin = _vin(seed, amp)
    want, want_state = _jax_run(jckt, jparams, mlp, vin, node)
    tparams = _to_port(jparams)
    got, got_state = _port_run(tckt, tparams, mlp, vin, node)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    assert sorted(got_state) == sorted(want_state)
    for k, d in want_state.items():
        for f, z in d.items():
            np.testing.assert_allclose(got_state[k][f].numpy(), np.asarray(z), atol=2e-5, rtol=0)


def test_state_carries_across_blocks():
    """Two half blocks equal one block (the Tube Screamer's three states)."""
    _, tckt, node, amp, seed, _ = _case("ts")
    root = tckt.root
    tparams = {**tckt.init_params("cpu"), **root.init_params("cpu")}
    vin = _vin(3, amp)
    full, full_state = _port_run(tckt, tparams, None, vin, node)
    h1, st = _port_run(tckt, tparams, None, vin[:, :T // 2], node)
    h2, st2 = _port_run(tckt, tparams, None, vin[:, T // 2:], node, state=st)
    np.testing.assert_allclose(torch.cat([h1, h2], dim=1).numpy(), full.numpy(), atol=1e-6,
                               rtol=0)
    for k in full_state:
        np.testing.assert_allclose(st2[k]["z"].numpy(), full_state[k]["z"].numpy(), atol=1e-6)


def test_plain_matches_circuit_process_with_static_controls():
    """A drive setting as a block-rate control equals the circuit built at
    that drive, and the port's own Circuit.process."""
    root = _port_diode()
    vin = _vin(8, 0.2, b=16, t=200)
    outs = []
    # the control as an f32 tensor, as the param is (a Python float would
    # take the adaptation's reciprocals in double)
    r6 = torch.tensor(tts.drive_to_r6(0.9), dtype=torch.float32)
    for drive, static in ((0.9, None), (0.2, {"R6": {"R": r6}})):
        ckt = tts.make_tube_screamer(root, FS, drive=drive)
        params = {**ckt.init_params("cpu"), **root.init_params("cpu")}
        out, _ = tfc.fused_circuit_process_plain(ckt, params, torch.from_numpy(vin),
                                                 _port_state(ckt, 16), static_controls=static)
        outs.append(out)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-6, rtol=0)
    ckt = tts.make_tube_screamer(root, FS, drive=0.9)
    params = {**ckt.init_params("cpu"), **root.init_params("cpu")}
    ref, _ = ckt.process(params, ckt.init_state("cpu"), {"Vin": {"v": torch.from_numpy(vin).T}})
    np.testing.assert_allclose(outs[0].numpy(), ref.T.numpy(), atol=2e-5, rtol=0)


def test_wrapper_runs_plain_on_cpu():
    _, tckt, node, amp, seed, _ = _case("hpf")
    tparams = {**tckt.init_params("cpu"), **tckt.root.init_params("cpu")}
    vin = _vin(seed, amp, b=32, t=64)
    tfc.fused_circuit_process.launches = 0
    got, got_state = _port_run(tckt, tparams, None, vin, node, plain=False)
    want, want_state = _port_run(tckt, tparams, None, vin, node)
    assert torch.equal(got, want) and torch.equal(got_state["C"]["z"], want_state["C"]["z"])
    assert tfc.fused_circuit_process.launches == 0


@pytest.mark.parametrize("entry", ["kernel", "plain", "neural", "neural_plain"])
def test_deferred_arguments_raise(entry):
    """The arguments of the training path: pot streams (``row_controls``)
    and the pre-step state trajectory (``return_state_seq``) through every
    entry match JAX's ``fused_circuit_process_neural`` in interpret mode.
    The training clipper with a random-init 2x4 root; one source R per row
    through the root-class entries, one per sample through ``_neural``."""
    b, t = 1024, 24
    jroot = JaxNeuralDiodeRoot(name="dp", n_layers=2, layer_size=4)
    mlp = jroot.init_params(jax.random.PRNGKey(5))["dp"]
    jckt = jdc.make_training_clipper(jroot, FS)
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=4)
    ckt = tdc.make_training_clipper(root, FS)
    rng = np.random.default_rng(9)
    if "neural" in entry:
        r = np.exp(np.log(45e3) + np.cumsum(0.02 * rng.standard_normal((b, t)), axis=1))
    else:
        r = np.exp(rng.uniform(np.log(36e3), np.log(73e3), b))
    r = r.astype(np.float32)
    vin = _vin(11, 1.5, b=b, t=t)
    jparams = jckt.init_params()
    want, want_state, want_seq = jfc.fused_circuit_process_neural(
        jckt, jparams, mlp, jnp.asarray(vin), {"C": {"z": jnp.zeros(b)}}, input_node="Vs",
        row_controls={"Vs": {"R": jnp.asarray(r)}}, interpret=True, return_state_seq=True)
    tmlp = _to_port(mlp)
    tparams = {**_to_port(jparams), "dp": tmlp}
    fn = {"kernel": tfc.fused_circuit_process, "plain": tfc.fused_circuit_process_plain,
          "neural": tfc.fused_circuit_process_neural,
          "neural_plain": tfc.fused_circuit_process_neural_plain}[entry]
    args = ((ckt, tparams, torch.from_numpy(vin)) if "neural" not in entry
            else (ckt, _to_port(jparams), tmlp, torch.from_numpy(vin)))
    got, got_state, got_seq = fn(*args, {"C": {"z": torch.zeros(b)}}, input_node="Vs",
                                 row_controls={"Vs": {"R": torch.from_numpy(r)}},
                                 return_state_seq=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_state["C"]["z"].numpy(), np.asarray(want_state["C"]["z"]),
                               atol=2e-5, rtol=0)
    assert len(got_seq) == len(want_seq) == 1
    np.testing.assert_allclose(got_seq[0].numpy(), np.asarray(want_seq[0]), atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="row control"):
        fn(*args, {"C": {"z": torch.zeros(b)}}, input_node="Vs",
           row_controls={"Vs": {"R": torch.ones(b + 1)}})


@pytest.mark.parametrize("entry", ["root", "neural"])
def test_non_tanh_net_raises(entry):
    """A relu-mixed MLP root: the NxH entry (``fused_circuit_process_neural``)
    raises as JAX's does (tests/test_deer_circuit.py:349-378);
    ``fused_circuit_process`` serves it with the general MLP root (its plain
    version here) within 2e-5 of JAX's scan, where JAX's generic kernel
    refuses it (ROADMAP queue C)."""
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=4,
                           activations=("relu", "tanh", "tanh", ""))
    ckt = tdc.make_diode_clipper(root, FS)
    mlp = root.init_params("cpu")["dp"]
    params = {**ckt.init_params("cpu"), "dp": mlp}
    if entry == "neural":
        vin, state = torch.zeros(4, 8), _port_state(ckt, 4)
        with pytest.raises(ValueError, match="all-tanh"):
            tfc.fused_circuit_process_neural(ckt, params, mlp, vin, state, input_node="Vs")
        return
    vin = _vin(5, b=4, t=64)
    got, got_state = tfc.fused_circuit_process(ckt, params, torch.from_numpy(vin),
                                               _port_state(ckt, 4), input_node="Vs")
    jroot = JaxNeuralDiodeRoot(name="dp", n_layers=2, layer_size=4,
                               activations=root.activations)
    jckt = jdc.make_diode_clipper(jroot, FS)
    jmlp = {"layers": [{k: jnp.asarray(v.numpy()) for k, v in l.items()} for l in mlp["layers"]]}
    want, want_state = jckt.process({**jckt.init_params(), "dp": jmlp}, {"C": {"z": jnp.zeros(4)}},
                                    {"Vs": {"v": jnp.asarray(vin.T)}})
    np.testing.assert_allclose(got.numpy(), np.asarray(want).T, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_state["C"]["z"].numpy(), np.asarray(want_state["C"]["z"]),
                               atol=2e-5, rtol=0)


def test_port_circuit_modules_import_no_jax():
    code = ("import sys\n"
            "import diffwdf_tpu_torch.ops.fused_circuit, diffwdf_tpu_torch.ops.circuit_codegen\n"
            "import diffwdf_tpu_torch.roots.distilled, diffwdf_tpu_torch.core.rtype\n"
            "import diffwdf_tpu_torch.models.tube_screamer\n"
            "import diffwdf_tpu_torch.models.simple_circuits, diffwdf_tpu_torch.nn.convert\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'diffwdf_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
