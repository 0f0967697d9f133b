"""Checkpoint/resume as NumPy ``.npz`` files (SURVEY.md §5 checkpoint row).

The reference only torch.saves the best model state_dict (no optimizer, no
resume — SURVEY.md §5); here checkpoints carry params + optimizer state +
step counter so training resumes exactly. Best-by-val-AUC retention mirrors
the reference's best-model selection.

Layout: one ``<step>.npz`` per checkpoint in the manager's directory. Each
leaf of the flattened state is stored under its key path (``jax.tree_util``
keystr), so a restore with a template rebuilds the exact pytree and one
without returns nested dicts. A checkpoint is written to a temporary file
and renamed into place, so a crash never leaves a truncated one behind.
"""

from __future__ import annotations

import os
import re
from typing import Any

import jax
import numpy as np

_STEP_FILE = re.compile(r"^(\d+)\.npz$")
# one component of a keystr path: ['dict key'], [index] or .attribute
_KEY_PART = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(\d+)\]|\.(\w+)")


def _flatten(state: Any) -> dict[str, np.ndarray]:
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in leaves}


def _nest(flat: dict[str, np.ndarray]) -> dict:
    """Nested dicts from keystr paths (``['a'][0]`` -> {'a': {0: ...}})."""
    out: dict = {}
    for key, value in flat.items():
        parts = [int(i) if i else (k or a)
                 for k, i, a in _KEY_PART.findall(key)]
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


class CheckpointManager:
    """Save/restore the full training state, keeping the newest
    ``max_to_keep`` checkpoints."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.npz")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self.directory)) if m)

    def save(self, step: int, params: Any, opt_state: Any,
             extra: dict | None = None):
        self.save_state(step, {"params": params, "opt_state": opt_state,
                               "extra": extra or {}})

    def save_state(self, step: int, state: Any):
        """Save an arbitrary training-state pytree (params, opt_state, best
        params, epoch counter, metrics) — the fit() periodic-checkpoint path."""
        tmp = os.path.join(self.directory, f".{step}.tmp.npz")
        with open(tmp, "wb") as f:
            np.savez(f, **_flatten(state))
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore_state(self, template: Any, step: int | None = None):
        """Restore the latest (or given) full training state into the
        structure of ``template``; None if there is no checkpoint."""
        return self.restore(step, template)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, template: Any = None,
                prefix: str = ""):
        """The latest (or given) checkpoint: nested dicts without a
        ``template``; with one, its exact pytree, read from the leaves under
        key path ``prefix`` (e.g. ``"['best_params']"`` restores one
        subtree). Empty subtrees are not stored, so only a template brings
        them back."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        with np.load(self._path(step)) as z:
            flat = {k: z[k] for k in z.files}
        if template is None:
            return _nest(flat)
        paths, treedef = jax.tree_util.tree_flatten_with_path(template)
        keys = [prefix + jax.tree_util.keystr(p) for p, _ in paths]
        missing = [k for k in keys if k not in flat]
        if missing:
            raise ValueError(f"checkpoint {step} lacks leaves {missing[:5]}")
        return jax.tree_util.tree_unflatten(treedef, [flat[k] for k in keys])

    def close(self):
        pass
