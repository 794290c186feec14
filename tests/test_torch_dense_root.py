"""The general MLP root of B7's generated forward (``circuit_codegen.
_DenseEmitter``, ``csrc/mlp_dense.cuh``) against the JAX package, on the CPU.

An MLP root outside the NxH family, with any activation of
``roots/neural._ACTS`` per layer and any widths (a JSON model that mixes
relu and tanh loads as one), which JAX serves through its jitted scan: for
each activation in every layer, a relu-mixed root loaded from its JSON, and
a model of unequal widths, in the LPF clipper (the Tube Screamer for one),
on seeded numpy weights and input,

- the generated forward built for the host (``registry.host_run``, the
  step the card runs) against JAX's ``Circuit.process`` at the JAX suite's
  2e-5 for the generic forward (tests/test_fused_circuit.py:55), and its
  plain version likewise;
- the stream's exact runner (B7 at B = 1), which served such a root by
  ``Circuit.process`` before, with a static source R;
- an artifact exported through B7's op and served on the CPU (its host
  build), within 1e-5 of the JAX scan (tests/test_artifact.py:46).

The NxH entry points keep refusing these roots, as JAX's kernels do
(tests/test_torch_fused_circuit.py, tests/test_torch_deer_circuit.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffwdf_tpu.models.diode_clipper import make_diode_clipper as jax_clipper
from diffwdf_tpu.models.tube_screamer import make_tube_screamer as jax_ts
from diffwdf_tpu.roots.neural import NeuralDiodeRoot as JaxNeuralDiodeRoot
from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper
from diffwdf_tpu_torch.models.tube_screamer import make_tube_screamer
from diffwdf_tpu_torch.nn.serialization import load_model_json, save_model_json
from diffwdf_tpu_torch.ops import circuit_codegen as cg
from diffwdf_tpu_torch.ops import fused_circuit as tfc
from diffwdf_tpu_torch.ops import registry
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot
from diffwdf_tpu_torch.runtime.artifact import load_artifact, save_artifact
from diffwdf_tpu_torch.runtime.stream import _generic_exact_runner, _lpf_exact_runner

FS = 96000.0
B, T = 3, 256

#: name -> (widths, activations, circuit)
CASES = {
    "tanh": ((2, 8, 8, 8, 1), ("tanh", "tanh", "tanh", "tanh"), "lpf"),  # a tanh head: no NxH
    "relu": ((2, 8, 8, 8, 1), ("relu", "relu", "relu", ""), "lpf"),
    "sigmoid": ((2, 8, 8, 8, 1), ("sigmoid", "sigmoid", "sigmoid", ""), "lpf"),
    "softmax": ((2, 8, 8, 8, 1), ("softmax", "softmax", "tanh", "linear"), "lpf"),
    "linear": ((2, 8, 8, 1), ("linear", "", "linear"), "lpf"),
    "relu_json": ((2, 8, 8, 8, 1), ("tanh", "relu", "tanh", ""), "lpf"),
    "unequal": ((2, 12, 5, 7, 1), ("tanh", "relu", "sigmoid", ""), "lpf"),
    "ts_relu": ((2, 8, 8, 8, 1), ("tanh", "relu", "tanh", ""), "ts"),
}


def _mlp(widths, seed):
    rng = np.random.default_rng(seed)
    return {"layers": [{"kernel": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32),
                        "bias": (0.3 * rng.standard_normal(o)).astype(np.float32)}
                       for i, o in zip(widths[:-1], widths[1:])]}


def _circuits(name, tmp_path):
    """(port circuit, port params, JAX circuit, JAX params, input node,
    amplitude): the same weights in both packages."""
    widths, acts, kind = CASES[name]
    mlp = _mlp(widths, len(name))
    tmlp = {"layers": [{k: torch.from_numpy(v) for k, v in l.items()} for l in mlp["layers"]]}
    if name == "relu_json":  # saved and loaded as a user's model file
        save_model_json(tmlp, acts, str(tmp_path / "relu.json"))
        tmlp, acts, _ = load_model_json(str(tmp_path / "relu.json"), device="cpu")
    root, frag = NeuralDiodeRoot.from_mlp("dp", tmlp, acts)
    jroot = JaxNeuralDiodeRoot(name="dp", n_layers=root.n_layers, layer_size=root.layer_size,
                               activations=tuple(acts))
    jfrag = {"dp": {"layers": [{k: jnp.asarray(v) for k, v in l.items()}
                               for l in mlp["layers"]]}}
    if kind == "ts":
        ckt, jckt = make_tube_screamer(root, FS, drive=0.5), jax_ts(jroot, FS, drive=0.5)
        node, amp = "Vin", 0.3
    else:
        ckt, jckt = make_diode_clipper(root, FS), jax_clipper(jroot, FS)
        node, amp = "Vs", 1.5
    return ckt, {**ckt.init_params("cpu"), **frag}, jckt, {**jckt.init_params(), **jfrag}, node, amp


@pytest.mark.parametrize("name", list(CASES))
def test_general_mlp_root_matches_jax_scan(name, tmp_path):
    ckt, params, jckt, jparams, node, amp = _circuits(name, tmp_path)
    rng = np.random.default_rng(7)
    vin = (amp * rng.standard_normal((B, T))).astype(np.float32)
    jstate = {k: {f: jnp.zeros(B) for f in d} for k, d in jckt.init_state().items()}
    want, _ = jckt.process(jparams, jstate, {node: {"v": jnp.asarray(vin.T)}})
    want = np.asarray(want).T

    prep = tfc.prepare(ckt, params, "cpu", input_node=node)
    assert isinstance(prep.prog.emitter, cg._DenseEmitter)
    assert '#include "mlp_dense.cuh"' in prep.prog.source
    # the lane form where a K of LANES divides every hidden width
    assert prep.prog.lanes == ((1,) if name == "unequal" else (1, 8))
    z0 = torch.zeros((len(prep.prog.state_order), B))
    out, _ = registry.host_run(prep.prog.host_source, torch.from_numpy(vin), z0, prep.vec,
                               prep.rows, prep.times, prep.warr)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=0)
    state = {k: {f: torch.zeros(B) for f in d} for k, d in ckt.init_state("cpu").items()}
    plain, _ = tfc.fused_circuit_process(ckt, params, torch.from_numpy(vin), state,
                                         input_node=node)
    np.testing.assert_allclose(plain.numpy(), want, atol=2e-5, rtol=0)

    # the exact runner (B7 at B = 1), with a static control of the served block
    run = _lpf_exact_runner(ckt) if node == "Vs" else _generic_exact_runner(ckt, node)
    static = {"Vs": {"R": 30e3}} if node == "Vs" else {"R6": {"R": 200e3}}
    x = torch.from_numpy(vin[0])
    got, _ = run(params, ckt.init_state("cpu"), {node: {"v": x}}, static)
    jwant, _ = jckt.process(jparams, jckt.init_state(), {node: {"v": jnp.asarray(vin[0])}},
                            static_controls=static)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=2e-5, rtol=0)

    # an artifact through B7's op, served on the CPU by its host build
    path = str(tmp_path / "root.pt2")
    meta = save_artifact(path, ckt, params, input_node=node, block_len=128, fs=FS)
    assert meta["kernel"] == "B7 circuit_forward"
    jfull, _ = jckt.process(jparams, jckt.init_state(), {node: {"v": jnp.asarray(vin[1])}})
    served = load_artifact(path, device="cpu").run(vin[1])
    assert np.max(np.abs(served - np.asarray(jfull))) < 1e-5
