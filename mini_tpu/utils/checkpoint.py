"""Checkpoint / resume for algorithm and model state.

The reference has no checkpointing (whole state is device arrays; jobs are
single-shot — SURVEY.md §5).  Here any pytree of arrays (problem state, GCN
params/opt state, partial algorithm results) round-trips through a single
``.npz`` file; the tree structure is stored alongside and VALIDATED at load
time so a structural mismatch fails loudly instead of loading garbage.
Orbax is available in the image for multi-host sharded checkpoints; this
lightweight path has no dependencies and is synchronous.
"""

from __future__ import annotations

import json

import numpy as np


def _treedef_str(treedef) -> str:
    return str(treedef)


def _key_paths(tree) -> list[str]:
    """Version-independent structure signature: the flattened key path of
    every leaf (dict keys, dataclass fields, sequence indices) rendered
    by ``jax.tree_util.keystr``.  Unlike ``str(treedef)`` this is
    comparable across jax versions, so a cross-version load still fails
    loudly when key NAMES differ even if leaf count/shape/dtype all
    match (a silent parameter permutation otherwise)."""
    import jax

    leaves_kp, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [jax.tree_util.keystr(kp) for kp, _ in leaves_kp]


def save_pytree(path: str, tree) -> None:
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(tree)
    arrays = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    meta = json.dumps(
        {
            "treedef": _treedef_str(treedef),
            "num_leaves": len(leaves),
            # str(treedef) is not stable API across jax versions: record the version it was rendered by, plus a
            # version-independent per-leaf signature that is always
            # checked
            "jax_version": jax.__version__,
            "leaf_sig": [
                [list(a.shape), str(a.dtype)] for a in arrays.values()
            ],
            "key_paths": _key_paths(tree),
        }
    )
    np.savez(
        path,
        __treedef__=np.frombuffer(meta.encode(), dtype=np.uint8),
        **arrays,
    )


def load_pytree(path: str, like):
    """Restore into the structure of ``like`` (a pytree with matching
    topology, e.g. the freshly-initialized state).

    Raises ``ValueError`` when the stored structure does not match
    ``like`` — leaf count or treedef mismatch means the checkpoint was
    written for a different state shape.
    """
    import jax
    import jax.numpy as jnp

    data = np.load(path)
    leaves_like, treedef = jax.tree_util.tree_flatten(like)
    n = len(leaves_like)

    stored_def, stored_n, stored_ver, stored_sig = None, None, None, None
    stored_paths = None
    if "__treedef__" in data:
        meta_raw = data["__treedef__"].tobytes().decode()
        try:
            meta = json.loads(meta_raw)
            stored_def = meta.get("treedef")
            stored_n = meta.get("num_leaves")
            stored_ver = meta.get("jax_version")
            stored_sig = meta.get("leaf_sig")
            stored_paths = meta.get("key_paths")
        except json.JSONDecodeError:
            # round-1 format stored json.dumps(str(treedef)) directly
            stored_def = json.loads(meta_raw)
            stored_n = sum(1 for k in data.files if k.startswith("leaf_"))
    if stored_n is not None and stored_n != n:
        raise ValueError(
            f"checkpoint {path!r} holds {stored_n} leaves but the target "
            f"structure has {n}"
        )
    if stored_sig is not None:
        # version-independent check: per-leaf shape/dtype vs the target
        got_sig = [
            [list(np.shape(l)), str(np.asarray(l).dtype)]
            for l in leaves_like
        ]
        if stored_sig != got_sig:
            raise ValueError(
                f"checkpoint {path!r} leaf signature mismatch:\n"
                f"  stored: {stored_sig}\n  target: {got_sig}"
            )
    if stored_paths is not None:
        # version-independent STRUCTURAL check (key names, not just leaf
        # shapes): keystr-rendered flattened key paths
        got_paths = _key_paths(like)
        if stored_paths != got_paths:
            raise ValueError(
                f"checkpoint {path!r} key-path mismatch:\n"
                f"  stored: {stored_paths}\n  target: {got_paths}"
            )
    # str(treedef) is only comparable when rendered by the same jax
    # version (its format is not stable API); cross-version loads rely
    # on the leaf count + signature + key-path checks above
    same_ver = stored_ver is None or stored_ver == jax.__version__
    if (
        stored_def is not None
        and same_ver
        and stored_def != _treedef_str(treedef)
    ):
        raise ValueError(
            f"checkpoint {path!r} tree structure mismatch:\n"
            f"  stored: {stored_def}\n  target: {_treedef_str(treedef)}"
        )
    leaves = [jnp.asarray(data[f"leaf_{i}"]) for i in range(n)]
    return jax.tree_util.tree_unflatten(treedef, leaves)
