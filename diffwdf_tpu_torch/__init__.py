"""diffwdf_tpu_torch — differentiable Wave Digital Filters in PyTorch and CUDA.

The PyTorch port of ``diffwdf_tpu``, with the same module paths and public
names: WDF elements, adaptors and circuits as pure functions over dicts of
tensors, analytic Wright-omega and neural diode roots with JSON weight
interchange, distilled Chebyshev roots, R-type adaptors, the diode-clipper
model zoo, the Tube Screamer and the simple circuits, and hand-written CUDA
kernels for batched clipper serving and training
(``diffwdf_tpu_torch.ops.fused_clipper``, ``ops.clipper_train``),
single-stream serving (``ops.parallel_time_deer``), batched serving of
any circuit through a kernel generated per circuit structure
(``ops.fused_circuit``), and in-circuit training of any such circuit
through a generated adjoint kernel (``ops.parallel_bptt``), pretraining of
neural roots (``training.pretrain``, epochs replayed from CUDA graphs),
parameter sweeps and model-zoo ensembles (``parallel.sweep``) and the
parallel-in-time oracle (``ops.parallel_time``).  It imports nothing of
JAX.
"""

from .core.elements import (
    Resistor,
    Capacitor,
    Inductor,
    ResistiveVoltageSource,
    ResistiveCurrentSource,
    voltage,
    current,
)
from .core.adaptors import Series, Parallel, Inverter
from .core.circuit import Circuit, Root, IdealVoltageSourceRoot, OpenCircuitRoot
from .roots.omega import wright_omega
from .roots.diode import (
    DiodeConfig,
    DiodePairRoot,
    default_diode,
    diode_1n4148_1u1d,
    diode_1n4148_1u2d,
    diode_1n4148_1u3d,
    diode_1n4148_2u2d,
    diode_1n4148_2u3d,
    diode_1n4148_3u3d,
    diode_oa1154_1u1d,
    diode_pair_reflected,
    diode_pair_reflected_symmetric,
    shockley_current,
)
from .roots.neural import MLP, NeuralDiodeRoot, mlp_init, mlp_apply, mlp_arch
from .nn.serialization import load_model_json, save_model_json

__version__ = "0.1.0"
