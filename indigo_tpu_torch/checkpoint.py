"""Solver-state checkpoint/resume.

Counterpart of ``indigo_tpu/checkpoint.py``, with its resume contract and
its ``.npz`` layout: ``save_state`` snapshots a nested ``dict``/``list``/
``tuple`` of tensors, numpy arrays and scalars, one array per leaf under
``leaf{i}`` (a complex leaf as real planes ``leaf{i}_re``/``leaf{i}_im``,
f32 for complex64), leaves numbered in the reference's order (dict keys
sorted, sequences in order, ``None`` holds no leaf). ``load_state``
restores it.

The structure is recorded as JSON under ``__indigo_structure_json__``, in
place of the reference's pickled tree definition, so ``load_state(path)``
rebuilds the nesting with no template and nothing is unpickled. Each
package ignores the other's ``__...__`` record: the port loads a file the
reference wrote when given ``like=`` (without one it returns the leaves
as a list, the reference's legacy form), and the reference loads a file
the port wrote when given ``like=``.

Operators are not state: an ``nn.Module`` inside ``state`` raises
``TypeError``. Save its ``state_dict()`` (the buffers, as tensors) and
rebuild the operator from code; the reference flattens its operators as
pytrees, but the port pickles no code.
"""
from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["save_state", "load_state"]

_RECORD = "__indigo_structure_json__"


def _flatten(node, leaves):
    """(JSON record of node, leaves appended in the reference's order)."""
    if isinstance(node, torch.nn.Module):
        raise TypeError(
            f"checkpoint: {type(node).__name__} is an operator (nn.Module), "
            "not state: save its state_dict() and rebuild it from code")
    if node is None:
        return {"none": None}
    if isinstance(node, dict):
        keys = sorted(node)
        return {"dict": [[k, _flatten(node[k], leaves)] for k in keys]}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_flatten(v, leaves) for v in node]}
    if torch.is_tensor(node):
        rec = {"tensor": str(node.dtype).replace("torch.", "")}
        arr = node.detach().cpu().numpy()
    elif isinstance(node, np.ndarray):
        rec, arr = {"ndarray": None}, node
    elif isinstance(node, np.generic):
        rec, arr = {"scalar": node.dtype.str}, np.asarray(node)
    elif isinstance(node, (bool, int, float, complex, str)):
        rec, arr = {"py": type(node).__name__}, np.asarray(node)
    else:
        raise TypeError(f"checkpoint: cannot store a {type(node).__name__}")
    if arr.dtype == object:
        raise TypeError("checkpoint: object arrays would need pickle")
    rec["leaf"] = len(leaves)
    leaves.append(arr)
    return rec


def save_state(path, state):
    """Snapshot ``state`` (nested dict/list/tuple of tensors, arrays and
    scalars) to ``path`` (.npz). Returns ``path``."""
    leaves = []
    record = _flatten(state, leaves)
    flat = {}
    for i, a in enumerate(leaves):
        if np.iscomplexobj(a):
            flat[f"leaf{i}_re"] = np.ascontiguousarray(a.real)
            flat[f"leaf{i}_im"] = np.ascontiguousarray(a.imag)
        else:
            flat[f"leaf{i}"] = a
    blob = np.frombuffer(json.dumps(record).encode(), dtype=np.uint8)
    np.savez(path, **{_RECORD: blob}, **flat)
    return path


def _stored(z, i):
    if f"leaf{i}_re" in z:
        re, im = z[f"leaf{i}_re"], z[f"leaf{i}_im"]
        cdt = np.result_type(re.dtype, np.complex64)
        return (re + 1j * im).astype(cdt)
    return z[f"leaf{i}"]


def _as_tensor(a, dtype, device=None):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def _rebuild(rec, leaves):
    """The node of a JSON record (tensors on the CPU)."""
    if "none" in rec:
        return None
    if "dict" in rec:
        return {k: _rebuild(v, leaves) for k, v in rec["dict"]}
    if "list" in rec:
        return [_rebuild(v, leaves) for v in rec["list"]]
    if "tuple" in rec:
        return tuple(_rebuild(v, leaves) for v in rec["tuple"])
    a = leaves[rec["leaf"]]
    if "tensor" in rec:
        return _as_tensor(a, getattr(torch, rec["tensor"]))
    if "scalar" in rec:
        return a.astype(np.dtype(rec["scalar"]))[()]
    if "py" in rec:
        return {"bool": bool, "int": int, "float": float, "complex": complex,
                "str": str}[rec["py"]](a[()])
    return a


def _like(node, leaves):
    """``node``'s structure with the stored leaves in order: a tensor in
    the template comes back as a tensor of its dtype on its device, a
    numpy scalar or Python number as its type, anything else as stored."""
    if isinstance(node, torch.nn.Module):
        raise TypeError(f"checkpoint: {type(node).__name__} is an operator "
                        "(nn.Module); load its state_dict() instead")
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _like(node[k], leaves) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_like(v, leaves) for v in node)
    a = next(leaves, None)
    if a is None:
        raise ValueError("checkpoint: the template holds more leaves than "
                         "the file")
    if torch.is_tensor(node):
        return _as_tensor(a, node.dtype, node.device)
    if isinstance(node, np.generic):
        return a.astype(node.dtype)[()]
    if isinstance(node, (bool, int, float, complex, str)):
        return type(node)(a[()])
    return a


def load_state(path, like=None):
    """Restore a state saved by ``save_state`` (or by the reference's).

    With no arguments beyond ``path``, the stored structure is used and the
    state comes back as written: tensors as CPU tensors of their dtype
    (move them with ``.to()``), arrays and scalars as numpy. Passing
    ``like`` (a state with the same structure) takes the structure from it
    instead: its tensor leaves come back as tensors of their dtype on
    their device. A file with no structure record (the reference's) and no
    ``like`` gives the list of leaves.
    """
    with np.load(path, allow_pickle=False) as z:
        names = [k for k in z.files if not k.startswith("__")]
        idxs = sorted({int(k.split("_")[0][4:]) for k in names})
        leaves = [_stored(z, i) for i in idxs]
        record = (json.loads(z[_RECORD].tobytes().decode())
                  if _RECORD in z.files else None)
    if like is not None:
        it = iter(leaves)
        out = _like(like, it)
        if next(it, None) is not None:
            raise ValueError(f"{path}: more leaves than the template holds")
        return out
    if record is None:
        return leaves
    return _rebuild(record, leaves)
