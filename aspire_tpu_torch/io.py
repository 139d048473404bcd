"""HDF5 persistence in the JAX package's layout (``aspire_tpu/io.py``).

A run file written by either package loads in the other: the same groups
(``/aspire_config``, ``/sampler_config``, ``/flow``, ``/checkpoint``), the
same value encoding (the ``__none__``, ``__string__``, ``__pickle__`` and
``__empty_dict__`` sentinels), pytrees stored leaf by leaf (``leaf_{i}``,
with ``leaf_spec``, ``n_leaves`` and ``treedef`` attributes) in the order
of ``jax.tree_util.tree_flatten`` (dict keys sorted, lists in order), and
particle arrays as shard datasets tagged with their global offsets, here
in their single-process form (one ``shard_p0_<starts>`` dataset).

``h5py`` is imported at first use: the port runs its samplers without it,
and every function here raises ``ImportError`` naming it where it is
missing.

A pickled value or checkpoint state is read by :func:`load_pickle`, which
maps the JAX package's classes that such a blob holds to the port's and
refuses every other global of the JAX package or of JAX.
"""

from __future__ import annotations

import io
import json
import pickle
from typing import Any

import numpy as np
import torch

from . import __version__ as _pkg_version
from .utils import require_module, to_numpy

_NONE = "__none__"
_EMPTY_DICT = "__empty_dict__"
_PICKLE = "__pickle__"
_STRING = "__string__"

#: the globals of the JAX package that its checkpoint blobs hold (the
#: SMC state's history and its sample-history snapshots), and the port's
#: classes they are read as; any other ``aspire_tpu`` or JAX global is
#: refused
JAX_CLASS_MAP = {
    ("aspire_tpu.history", "SMCHistory"): ("aspire_tpu_torch.history",
                                           "SMCHistory"),
    ("aspire_tpu.samples", "SMCSamples"): ("aspire_tpu_torch.samples",
                                           "SMCSamples"),
}
_REFUSED_ROOTS = ("aspire_tpu", "jax", "jaxlib")


def h5py_module():
    return require_module("h5py", "HDF5 persistence")


_ASPIRE_FILE = None


def AspireFile(*args, **kwargs):
    """An ``h5py.File`` stamped, when opened for writing, with the
    ``aspire_tpu_version`` attribute (the port's version)."""
    global _ASPIRE_FILE
    if _ASPIRE_FILE is None:
        h5py = h5py_module()

        class _AspireFile(h5py.File):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                if self.mode != "r":
                    self.attrs["aspire_tpu_version"] = _pkg_version

        _ASPIRE_FILE = _AspireFile
    return _ASPIRE_FILE(*args, **kwargs)


# -- pickles ------------------------------------------------------------------


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in JAX_CLASS_MAP:
            module, name = JAX_CLASS_MAP[module, name]
        elif module.split(".")[0] in _REFUSED_ROOTS:
            raise pickle.UnpicklingError(
                f"refusing the global {module}.{name}: the port reads of the "
                "JAX package's pickles only the classes of JAX_CLASS_MAP "
                f"({sorted('.'.join(k) for k in JAX_CLASS_MAP)})")
        return super().find_class(module, name)


def load_pickle(data: bytes) -> Any:
    """Unpickle ``data`` (a port or JAX package blob) through the restricted
    unpickler, then complete what a JAX package object lacks: samples are
    rebuilt by the port's constructor (as host snapshots), histories get
    the port's extra fields."""
    return _adapt(_Unpickler(io.BytesIO(data)).load())


def _adapt(obj: Any) -> Any:
    from .history import History
    from .samples import BaseSamples

    if isinstance(obj, dict):
        return {k: _adapt(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_adapt(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_adapt(v) for v in obj)
    if isinstance(obj, BaseSamples) and "device" not in vars(obj):
        fields = {f.name: vars(obj)[f.name]
                  for f in obj.__dataclass_fields__.values()
                  if f.init and f.name in vars(obj)}
        return type(obj)(**fields).to_numpy()
    if isinstance(obj, History):
        for f in obj.__dataclass_fields__.values():
            if f.name not in vars(obj):
                setattr(obj, f.name, f.default_factory())
        if hasattr(obj, "sample_history"):
            obj.sample_history = _adapt(obj.sample_history)
    return obj


# -- dicts ----------------------------------------------------------------------


def _encode_value(value: Any) -> Any:
    """One value in an HDF5-storable form (the JAX package's encoding)."""
    if value is None:
        return np.bytes_(_NONE)
    if isinstance(value, str):
        return np.bytes_(_STRING + value)
    if isinstance(value, (bool, np.bool_)):
        return np.bool_(value)
    if isinstance(value, (int, float, complex, np.number)):
        return value
    if isinstance(value, torch.Tensor):
        return to_numpy(value)
    if isinstance(value, np.ndarray):
        return value
    if isinstance(value, (list, tuple)):
        try:
            arr = np.asarray(value)
            if arr.dtype.kind in "ifubc":
                return arr
            if arr.dtype.kind == "U":
                return np.array([s.encode() for s in arr.ravel()]).reshape(
                    arr.shape)
        except (ValueError, TypeError):
            pass
    return np.void(_PICKLE.encode() + pickle.dumps(value))


def _decode_value(value: Any) -> Any:
    if isinstance(value, bytes):
        if value == _NONE.encode():
            return None
        if value.startswith(_STRING.encode()):
            return value[len(_STRING):].decode()
        return value.decode()
    if isinstance(value, np.void):
        raw = bytes(value.tobytes())
        if raw.startswith(_PICKLE.encode()):
            return load_pickle(raw[len(_PICKLE):])
        return raw
    if isinstance(value, np.ndarray):
        if value.dtype.kind == "S":
            if value.ndim == 0:
                return _decode_value(value.item())
            return [_decode_value(v) for v in value.ravel()]
        if value.ndim == 0:
            return value.item()
        return value
    if isinstance(value, np.generic):
        return value.item()
    return value


def save_dict_to_hdf5(h5_file, path: str, dictionary: dict) -> None:
    """Save a (nested) dict under ``path``, replacing what is there."""
    if path in h5_file:
        del h5_file[path]
    _save_dict(h5_file.require_group(path), dictionary)


def _save_dict(group, dictionary: dict) -> None:
    for key, value in dictionary.items():
        key = str(key)
        if key in group:
            del group[key]
        if isinstance(value, dict):
            if not value:
                group.create_dataset(key, data=np.bytes_(_EMPTY_DICT))
            else:
                _save_dict(group.create_group(key), value)
        else:
            group.create_dataset(key, data=_encode_value(value))


def load_dict_from_hdf5(h5_file, path: str) -> dict:
    """A dict saved by :func:`save_dict_to_hdf5` (either package's)."""
    return _load_group(h5_file[path])


def _load_group(group) -> dict:
    h5py = h5py_module()
    out = {}
    for key, item in group.items():
        if isinstance(item, h5py.Group):
            out[key] = _load_group(item)
        else:
            value = item[()]
            if isinstance(value, bytes) and value == _EMPTY_DICT.encode():
                out[key] = {}
            else:
                out[key] = _decode_value(value)
    return out


# -- pytrees --------------------------------------------------------------------


def tree_flatten(tree: Any) -> list:
    """The leaves of a nested dict/list/tuple in
    ``jax.tree_util.tree_flatten``'s order: dict keys sorted, sequences in
    order, ``None`` no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_flatten(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """``like``'s structure with its leaves replaced by ``leaves`` (in
    :func:`tree_flatten`'s order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def treedef_string(tree: Any) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(tree))`` prints
    it (informative only: a loader takes the structure from a template)."""
    def node(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(node(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(node(v) for v in t) + (
                ",)" if len(t) == 1 else ")")
        return "*"

    return f"PyTreeDef({node(tree)})"


def save_pytree_to_hdf5(h5_file, path: str, tree: Any) -> None:
    """Save a nested dict/list of tensors leaf by leaf (``leaf_{i}`` in the
    JAX flatten order, the spec, count and structure as attributes)."""
    if path in h5_file:
        del h5_file[path]
    group = h5_file.require_group(path)
    leaves = tree_flatten(tree)
    spec = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, (torch.Tensor, np.ndarray)):
            arr = to_numpy(leaf)
            group.create_dataset(f"leaf_{i}", data=arr)
            spec.append({"kind": "array", "dtype": str(arr.dtype)})
        elif isinstance(leaf, (bool, int, float, complex, str)):
            spec.append({"kind": "json", "value": leaf})
        else:
            group.create_dataset(f"leaf_{i}",
                                 data=np.void(pickle.dumps(leaf)))
            spec.append({"kind": "pickle"})
    group.attrs["treedef"] = treedef_string(tree)
    group.attrs["leaf_spec"] = json.dumps(spec)
    group.attrs["n_leaves"] = len(leaves)


def load_pytree_from_hdf5(h5_file, path: str, like: Any) -> Any:
    """A pytree saved by either package, in ``like``'s structure; array
    leaves as tensors of the template leaf's device (and dtype)."""
    group = h5_file[path]
    spec = json.loads(group.attrs["leaf_spec"])
    like_leaves = tree_flatten(like)
    if len(like_leaves) != len(spec):
        raise ValueError(
            f"Pytree structure mismatch: file has {len(spec)} leaves, "
            f"template has {len(like_leaves)}")
    leaves = []
    for i, (entry, like_leaf) in enumerate(zip(spec, like_leaves)):
        if entry["kind"] == "array":
            arr = np.asarray(group[f"leaf_{i}"][()])
            if (hasattr(like_leaf, "shape")
                    and tuple(like_leaf.shape) != tuple(arr.shape)):
                raise ValueError(
                    f"Leaf {i} shape mismatch: file {arr.shape} vs "
                    f"template {tuple(like_leaf.shape)}")
            if isinstance(like_leaf, torch.Tensor):
                leaves.append(torch.as_tensor(arr).to(
                    device=like_leaf.device, dtype=like_leaf.dtype))
            else:
                leaves.append(arr)
        elif entry["kind"] == "json":
            leaves.append(entry["value"])
        else:
            leaves.append(load_pickle(bytes(group[f"leaf_{i}"][()])))
    return tree_unflatten(like, leaves)


# -- particle arrays --------------------------------------------------------------


def save_sharded_array(h5_file, path: str, arr) -> None:
    """Write ``arr`` (a tensor or array) as one shard spanning its global
    shape: the single-process form of the JAX package's shard layout."""
    if path in h5_file:
        del h5_file[path]
    group = h5_file.require_group(path)
    arr = to_numpy(arr)
    group.attrs["global_shape"] = np.asarray(arr.shape, dtype=np.int64)
    group.attrs["dtype"] = str(arr.dtype)
    starts = (0,) * arr.ndim
    ds = group.create_dataset(
        "shard_p0_" + "_".join(map(str, starts)), data=arr)
    ds.attrs["start"] = np.asarray(starts, dtype=np.int64)


def load_sharded_array(h5_files, path: str) -> np.ndarray:
    """Reassemble an array saved shard-wise (by either package, from one
    file or several) into host numpy; an element no shard covers raises."""
    if not isinstance(h5_files, (list, tuple)):
        h5_files = [h5_files]
    groups = [f[path] for f in h5_files if path in f]
    if not groups:
        raise KeyError(f"No shard group {path!r} in the given files")
    shape = tuple(int(s) for s in groups[0].attrs["global_shape"])
    out = np.empty(shape, np.dtype(groups[0].attrs["dtype"]))
    filled = np.zeros(shape, dtype=bool)
    for group in groups:
        for ds in group.values():
            starts = tuple(int(s) for s in ds.attrs["start"])
            region = tuple(slice(s, s + e) for s, e in zip(starts, ds.shape))
            out[region] = ds[()]
            filled[region] = True
    if not filled.all():
        raise ValueError(
            f"Shard files leave {int(filled.size - filled.sum())}/"
            f"{filled.size} elements of {path!r} unfilled (missing "
            "per-process shard files?)")
    return out


# -- state bytes ------------------------------------------------------------------


def save_state_bytes(h5_file, payload: bytes,
                     path: str = "checkpoint") -> None:
    """Write opaque state bytes at ``{path}/state``."""
    group = h5_file.require_group(path)
    if "state" in group:
        del group["state"]
    group.create_dataset("state", data=np.frombuffer(payload, dtype=np.uint8),
                         maxshape=(None,))


def load_state_bytes(h5_file, path: str = "checkpoint") -> bytes:
    return bytes(np.asarray(h5_file[path]["state"][()]).tobytes())
