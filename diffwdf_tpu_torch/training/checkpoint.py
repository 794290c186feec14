"""Checkpoint / resume: params + optimizer state + step.

The reference only exports final weights to JSON (``model_utils.py:82-85``)
and warm-starts circuit training from pretrained JSONs
(``clipper_pot.py:132-137``) — no optimizer state, no mid-run resume.  Here a
checkpoint carries the full training state so a run resumes exactly: params,
the optimizer's ``state_dict()``, and the step counter.

On-disk layout, the same as the JAX package's: a directory holding

- ``arrays.npz``: every params leaf under ``params|<path>``, the path of
  dict keys and list indices joined with "/" (``params|dp/layers/0/kernel``),
  so params saved here load in the JAX package's ``restore_checkpoint``;
  the optimizer's per-parameter tensors under ``opt_state|state/<i>/<name>``
  and its ``param_groups`` as JSON text under ``opt_state|param_groups``;
- ``meta.json``: ``{"step", "extra"}``, the commit marker, written last.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten_with_paths(tree, prefix: str = ""):
    """{path: numpy leaf} of a nested dict / list / tuple of tensors, paths
    of keys and indices joined with "/"."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(torch.as_tensor(tree).detach().cpu())}
    out = {}
    for k, v in items:
        out.update(_flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _refill(template, data, prefix: str, path: str = ""):
    """A tree shaped like ``template`` with each leaf read from
    ``data[f"{prefix}|{path}"]`` and placed on the template leaf's device."""
    if isinstance(template, dict):
        items = template.items()
    elif isinstance(template, (list, tuple)):
        items = enumerate(template)
    else:
        return torch.as_tensor(data[f"{prefix}|{path}"], device=torch.as_tensor(template).device)
    leaves = [(k, _refill(v, data, prefix, f"{path}/{k}" if path else str(k))) for k, v in items]
    return dict(leaves) if isinstance(template, dict) else type(template)(v for _, v in leaves)


def save_checkpoint(
    path: str,
    params,
    opt_state: Optional[Dict[str, Any]] = None,
    step: int = 0,
    extra: Optional[Dict[str, Any]] = None,
):
    """Write a checkpoint.  path is a directory; atomic via tmp+rename.
    ``opt_state`` is an optimizer's ``state_dict()``.

    meta.json is the commit marker: it is written (tmp+rename) only after
    arrays.npz is in place, and ``latest_checkpoint`` ignores directories
    without it — a crash mid-save can never brick a resume.
    """
    os.makedirs(path, exist_ok=True)
    tmp = path + ".tmp.npz"
    arrays = {f"params|{k}": v for k, v in _flatten_with_paths(params).items()}
    if opt_state is not None:
        for k, v in _flatten_with_paths(opt_state["state"], "state").items():
            arrays[f"opt_state|{k}"] = v
        arrays["opt_state|param_groups"] = np.asarray(json.dumps(opt_state["param_groups"]))
    np.savez(tmp, **arrays)
    final_npz = os.path.join(path, "arrays.npz")
    # Overwriting an existing committed checkpoint: retract the commit marker
    # FIRST so a crash between the arrays replace and the meta replace leaves
    # the directory uncommitted (stale meta must never describe new arrays).
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(final_npz) and os.path.exists(meta_path):
        os.unlink(meta_path)
    os.replace(tmp, final_npz)
    meta = {"step": int(step), "extra": extra or {}}
    tmp_meta = path + ".tmp.meta.json"
    with open(tmp_meta, "w") as f:
        json.dump(meta, f)
    os.replace(tmp_meta, os.path.join(path, "meta.json"))


def restore_checkpoint(path: str, params_template, opt_state_template=None):
    """Restore params into the given template (structure must match; each
    leaf lands on its template leaf's device).

    Returns (params, opt_state, step, extra).  opt_state is the saved
    optimizer ``state_dict()`` (for ``optimizer.load_state_dict``) when a
    template is given (any value, e.g. the optimizer's current
    ``state_dict()``) and one was saved, else None.
    """
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = dict(data)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)

    params = _refill(params_template, arrays, "params")
    opt_state = None
    if opt_state_template is not None and "opt_state|param_groups" in arrays:
        state: Dict[int, Dict[str, torch.Tensor]] = {}
        for key, value in arrays.items():
            if key.startswith("opt_state|state/"):
                _, index, name = key.split("|", 1)[1].split("/")
                state.setdefault(int(index), {})[name] = torch.from_numpy(value)
        opt_state = {"state": state,
                     "param_groups": json.loads(str(arrays["opt_state|param_groups"]))}
    return params, opt_state, meta["step"], meta["extra"]


def latest_checkpoint(base_dir: str) -> Optional[str]:
    """Find the highest-step checkpoint under base_dir (dirs named step_N)."""
    if not os.path.isdir(base_dir):
        return None
    steps = []
    for d in os.listdir(base_dir):
        full = os.path.join(base_dir, d)
        # meta.json is the commit marker (see save_checkpoint): a directory
        # without it is an interrupted save, not a restorable checkpoint
        if (
            d.startswith("step_")
            and os.path.isdir(full)
            and os.path.exists(os.path.join(full, "meta.json"))
        ):
            try:
                steps.append((int(d.split("_")[1]), d))
            except ValueError:
                pass
    if not steps:
        return None
    return os.path.join(base_dir, max(steps)[1])
