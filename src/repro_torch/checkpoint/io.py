"""Tree checkpointing: flat-path .npz payload + JSON manifest.

Port of ``repro/checkpoint/io.py`` (format 2), file for file compatible:
a checkpoint written by either package loads in the other.

Layout:  <dir>/step_<n>/arrays.npz  +  <dir>/step_<n>/manifest.json
Each leaf is stored under its key path joined with ``/`` (NamedTuple
fields by name, dict keys sorted, list indices: the JAX package's
``path_str`` of ``tree_flatten_with_path``), and a checkpoint restores
into the structure of a template tree.  bfloat16, which numpy lacks, is
stored as the raw 2-byte records numpy writes for the JAX package's
bfloat16 arrays (dtype ``V2``) and read back by the template's dtype.

Crash safety contract (format 2):

* Writes are atomic: the payload + manifest land in a hidden temp dir
  (fsync'd file by file, then the directory), which is renamed into
  place in one step.  A SIGKILL at any instant leaves either the old
  step set or the new one, never a half-written ``step_<n>``.
* The manifest carries a CRC-32 of ``arrays.npz``, so a torn payload
  (truncated file, bit rot) is detectable without parsing it.
* Readers are fallback-tolerant: :func:`latest_step` and
  :func:`load_checkpoint` skip unreadable or checksum-failing step dirs
  with a warning and fall back to the newest VALID step.
* :func:`_gc` never deletes the newest valid step, whatever ``keep``
  says: a run can always resume from something.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import warnings
import zlib

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves_with_path, tree_unflatten_like

# anchored full-name match: in-progress temp dirs never parse as steps
_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_PREFIX = ".tmp-"
CHECKPOINT_FORMAT = 2
# numpy's record type for a 2-byte dtype it does not know (bfloat16)
_RAW2 = np.dtype("V2")


def path_str(path: tuple) -> str:
    """A key path of ``tree_leaves_with_path`` as the stored leaf name."""
    return "/".join(str(k) for k in path)


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(_RAW2)
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of the template leaf ``like``'s dtype and
    device."""
    if arr.dtype == _RAW2:
        if like.dtype != torch.bfloat16:
            raise TypeError(f"a raw 2-byte leaf restores into bfloat16 only, "
                            f"not {like.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _flatten(tree) -> dict:
    return {path_str(p): _to_numpy(v) for p, v in tree_leaves_with_path(tree)}


def _crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while block := f.read(chunk):
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(ckpt_dir: str, step: int, tree, metadata: dict | None = None,
                    keep: int = 3) -> str:
    out = os.path.join(ckpt_dir, f"step_{step}")
    tmp = os.path.join(ckpt_dir, f"{_TMP_PREFIX}step_{step}-{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(tree)
    arrays = os.path.join(tmp, "arrays.npz")
    with open(arrays, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    manifest = {"format": CHECKPOINT_FORMAT, "step": step,
                "paths": sorted(flat),
                "checksum": {"arrays.npz": _crc32(arrays)},
                "metadata": metadata or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(tmp)
    if os.path.exists(out):
        shutil.rmtree(out)
    os.rename(tmp, out)
    _fsync_path(ckpt_dir)
    _gc(ckpt_dir, keep)
    return out


def checkpoint_valid(path: str) -> bool:
    """Whether ``path`` (a ``step_<n>`` dir) holds a loadable checkpoint.

    Format-2 dirs verify the manifest's CRC-32 against the payload
    bytes; legacy (pre-checksum) dirs fall back to parsing the payload
    with ``np.load``.  Any IO/parse failure means invalid: callers skip
    and fall back, they never raise here.
    """
    arrays = os.path.join(path, "arrays.npz")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        expect = manifest.get("checksum", {}).get("arrays.npz")
        if expect is not None:
            return _crc32(arrays) == int(expect)
        with np.load(arrays) as data:          # legacy: no checksum
            missing = set(manifest.get("paths", [])) - set(data.files)
        return not missing
    except Exception:
        return False


def _all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                  if (m := _STEP_RE.fullmatch(d)))


def valid_steps(ckpt_dir: str, warn: bool = True) -> list[int]:
    """Ascending step numbers whose dirs pass :func:`checkpoint_valid`;
    invalid dirs are reported once via ``warnings.warn``."""
    good = []
    for s in _all_steps(ckpt_dir):
        path = os.path.join(ckpt_dir, f"step_{s}")
        if checkpoint_valid(path):
            good.append(s)
        elif warn:
            warnings.warn(f"skipping corrupt/partial checkpoint {path}",
                          RuntimeWarning, stacklevel=2)
    return good


def latest_step(ckpt_dir: str) -> int | None:
    steps = valid_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load_step(ckpt_dir: str, template, step: int):
    path = os.path.join(ckpt_dir, f"step_{step}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = []
        for p, like in tree_leaves_with_path(template):
            key = path_str(p)
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            leaves.append(_from_numpy(data[key], like))
    return tree_unflatten_like(template, leaves), step


def load_checkpoint(ckpt_dir: str, template, step: int | None = None):
    """Restore into the structure of ``template``; each leaf comes back
    with its template leaf's dtype and device.

    With ``step=None``, walks valid steps newest-first and returns the
    first that actually loads, warning past any that fail mid-read (a
    dir can still vanish under gc from a concurrent writer).  An
    explicit ``step`` loads exactly that step or raises.
    """
    if step is not None:
        return _load_step(ckpt_dir, template, step)
    failures = []
    for s in reversed(valid_steps(ckpt_dir)):
        try:
            return _load_step(ckpt_dir, template, s)
        except Exception as e:  # pragma: no cover - vanishing-dir race
            failures.append(f"step_{s}: {e}")
            warnings.warn(f"failed to load checkpoint step_{s} ({e}); "
                          "falling back", RuntimeWarning, stacklevel=2)
    detail = f" (tried: {failures})" if failures else ""
    raise FileNotFoundError(f"no loadable checkpoints under {ckpt_dir}"
                            f"{detail}")


def load_metadata(ckpt_dir: str, step: int) -> dict:
    """The manifest's ``metadata`` dict for one step (``{}`` when the
    manifest carries none).  Reads only the JSON manifest."""
    path = os.path.join(ckpt_dir, f"step_{step}", "manifest.json")
    with open(path) as f:
        return json.load(f).get("metadata") or {}


def _gc(ckpt_dir: str, keep: int):
    """Prune old steps and stale temp dirs.

    Only VALID steps count toward ``keep``, and the newest valid step is
    never deleted: even with ``keep=0`` a crash-interrupted run keeps a
    resume point.  Invalid (corrupt) step dirs older than the newest
    valid one are reclaimed.
    """
    good = valid_steps(ckpt_dir, warn=False)
    protect = set(good if keep <= 0 else good[-max(keep, 1):])
    newest_valid = good[-1] if good else None
    for s in _all_steps(ckpt_dir):
        if s in protect:
            continue
        if s not in good and (newest_valid is None or s > newest_valid):
            continue  # corrupt-but-newer: leave for post-mortem
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)
    for d in os.listdir(ckpt_dir):
        if d.startswith(_TMP_PREFIX) \
                and not d.endswith(f"-{os.getpid()}"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
