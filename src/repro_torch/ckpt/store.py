"""Checkpointing: atomic step checkpoints, an asynchronous checkpointer,
and the template-free ``pytree_v1`` artifacts (counterpart of
``repro/ckpt/store.py``). Both formats are the JAX package's, key for key:
what either package writes, the other reads.

Step checkpoints (``save``/``restore``, a training state):

    <dir>/step_000000042/arrays.npz     flat {escaped path -> np array}
    <dir>/step_000000042/manifest.json  step, keys, shapes, dtypes, meta
    <dir>/LATEST                        atomic pointer ("step_000000042")

An npz key is the tree path joined by "␟", a NamedTuple field giving its
name: ``params␟decoder␟run0␟attn␟wq␟w``, ``opt␟mu␟…``, ``opt␟step``.
``restore`` reads into a template (a tree of the same structure, e.g. a
fresh ``init_train_state``, which may lie on the ``meta`` device) and casts
every leaf to the template's dtype.

Template-free artifacts, layout of ``<dir>/<name>/``:

    arrays.npz       flat {path joined by "␟" -> numpy array}
    manifest.json    {"format": "pytree_v1", "structure", "hashes", "meta"}

The manifest records the tree itself (nested dict keys, list and tuple
lengths, each leaf's dtype), so a D-Rank compressed model, whose list-form
tree only exists after compression, loads without a template. A leaf that is
the same tensor object as an earlier one (a group's shared basis B) is
stored once and comes back as one tensor. The format is byte-compatible with
the JAX package's: an artifact written by either package loads in the
other, and the same arrays give the same content hashes.

* dtypes are numpy's names ("float32", "bfloat16"), never torch's;
* a bfloat16 leaf is stored as float32 (npz cannot hold bfloat16; the
  widening is exact) and the manifest keeps ``"dtype": "bfloat16"``;
* a content hash covers the STORED numpy array: its dtype name, its shape
  as numpy prints it, and its bytes.

The asynchronous checkpointer copies the tree to the host before
``submit`` returns and writes it on a worker thread.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.device import DeviceLike, resolve_device

_SEP = "␟"      # unit-separator glyph: safe path joiner for npz keys


class IntegrityError(ValueError):
    """A stored artifact failed verification (sha256 mismatch, truncated
    or unreadable blob, missing arrays). Subclasses ValueError so callers
    that predate the typed error keep working."""


def _dtype_name(node) -> str:
    """numpy's name for a leaf's dtype (``torch.bfloat16`` -> "bfloat16")."""
    if isinstance(node, torch.Tensor):
        return str(node.dtype).removeprefix("torch.")
    return str(node.dtype)


def _to_numpy(node) -> np.ndarray:
    """The array as stored: on the host, float32 in place of bfloat16 (and
    of any dtype npz cannot hold)."""
    if isinstance(node, torch.Tensor):
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    arr = np.asarray(node)
    if arr.dtype.kind not in "fiub" or str(arr.dtype) == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A stored array as a tensor, of its shape (``ascontiguousarray``
    alone makes a 0-d array 1-d)."""
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {pytree.joined(path, _SEP): _to_numpy(leaf)
            for path, leaf in pytree.flatten_with_path(tree)}


def save(ckpt_dir: str, step: int, tree, meta: Optional[Dict] = None,
         keep_last: int = 3) -> str:
    """Synchronous atomic save of a tree of tensors (or numpy arrays).
    Returns the checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:09d}"
    final = os.path.join(ckpt_dir, name)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_{name}_")
    try:
        arrays = _flatten(tree)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "time": time.time(),
            "keys": sorted(arrays.keys()),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
            "meta": meta or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic LATEST pointer
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(name)
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    _cleanup(ckpt_dir, keep_last)
    return final


def _cleanup(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    path = os.path.join(ckpt_dir, name)
    if not os.path.exists(path):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, template, step: Optional[int] = None,
            shardings=None, device: DeviceLike = None) -> Tuple[int, Any]:
    """Load the checkpoint at ``step`` (default: ``LATEST``) into the
    template's structure, each leaf cast to the template leaf's dtype and
    placed on ``device`` (default: the template leaf's device; a template
    on the ``meta`` device needs ``device``). Only the template's structure
    and dtypes are read.

    ``shardings``: a tree shaped like the template whose leaves are
    ``dist.sharding.NamedSharding`` (or None: the whole leaf). Each rank
    then loads only its ``local_block`` of each leaf under the sharding's
    spec and mesh, JAX's elastic reshard on load; the template leaf gives
    the dtype and device, and its shape is not read."""
    shard_of = ([None] * len(pytree.leaves(template)) if shardings is None
                else pytree.leaves(shardings))
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    dev = None if device is None else resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    leaves = []
    # an npz member is read when it is asked for: keys that the template
    # does not hold stay on the disk
    flat = pytree.flatten_with_path(template)
    if len(shard_of) != len(flat):
        raise ValueError(f"restore: {len(shard_of)} shardings for "
                         f"{len(flat)} template leaves")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for (pth, leaf), shd in zip(flat, shard_of):
            leaves.append(_restore_leaf(z, pytree.joined(pth, _SEP), leaf,
                                        dev, shd))
    return step, pytree.unflatten(template, leaves)


def _restore_leaf(z, key: str, leaf, dev, sharding=None):
    if key not in z.files:
        raise KeyError(f"checkpoint missing {key}")
    arr = _from_numpy(z[key])
    if sharding is not None:
        from repro_torch.dist.sharding import local_block
        arr = local_block(arr, sharding.spec, sharding.mesh).contiguous()
    if isinstance(leaf, torch.Tensor):
        where = dev if dev is not None else leaf.device
        if where.type == "meta":
            raise ValueError("restore: the template lies on the meta "
                             "device; pass device=")
        return arr.to(device=where, dtype=leaf.dtype)
    return arr if dev is None else arr.to(device=dev)


def _encode_pytree(tree):
    arrays: Dict[str, np.ndarray] = {}
    seen: Dict[int, str] = {}

    def walk(node, path):
        if isinstance(node, dict):
            return {"kind": "dict",
                    "items": {k: walk(v, path + (str(k),))
                              for k, v in node.items()}}
        if isinstance(node, (list, tuple)):
            return {"kind": "list" if isinstance(node, list) else "tuple",
                    "items": [walk(v, path + (str(i),))
                              for i, v in enumerate(node)]}
        if not hasattr(node, "shape"):
            raise TypeError(f"non-array leaf at {'/'.join(path)}: "
                            f"{type(node).__name__}")
        key = _SEP.join(path)
        spec = {"kind": "leaf", "key": key, "dtype": _dtype_name(node)}
        if id(node) in seen:
            spec["alias"] = seen[id(node)]
            return spec
        seen[id(node)] = key
        arrays[key] = _to_numpy(node)
        return spec

    return walk(tree, ()), arrays


def _content_hash(arr: np.ndarray) -> str:
    """Content hash of one stored array: dtype + shape + raw bytes, so a
    silent bit flip, truncation, or shape rewrite all change the digest."""
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def save_pytree(ckpt_dir: str, tree, meta: Optional[Dict] = None,
                name: str = "pytree") -> str:
    """Atomic template-free save of a dict/list/tuple pytree of tensors (or
    numpy arrays) to ``<ckpt_dir>/<name>/``. Returns the artifact path. The
    manifest records a sha256 content hash per stored array;
    ``load_pytree(verify=True)`` re-checks them."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, name)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_{name}_")
    try:
        structure, arrays = _encode_pytree(tree)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "format": "pytree_v1",
            "time": time.time(),
            "structure": structure,
            "hashes": {k: _content_hash(v) for k, v in arrays.items()},
            "meta": meta or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def load_pytree(ckpt_dir: str, name: str = "pytree", verify: bool = False,
                device: DeviceLike = None) -> Tuple[Any, Dict]:
    """Inverse of ``save_pytree``: returns ``(tree, meta)`` with every leaf a
    tensor on ``device`` (the card by default) in its recorded dtype.
    Aliased leaves come back as the SAME tensor (shared-basis dedup
    survives the round trip). ``verify=True`` re-hashes every stored array
    against the manifest's content hashes and raises ``IntegrityError`` on
    any mismatch, or ``ValueError`` if the artifact predates hashing."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, name)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != "pytree_v1":
        raise ValueError(f"{path}: not a pytree_v1 artifact")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    if verify:
        hashes = manifest.get("hashes")
        if not hashes:
            raise ValueError(
                f"{path}: artifact has no content hashes (saved before "
                f"integrity hashing); re-save to enable verify")
        bad = sorted(k for k in hashes
                     if k not in arrays
                     or _content_hash(arrays[k]) != hashes[k])
        extra = sorted(set(arrays) - set(hashes))
        if bad or extra:
            raise IntegrityError(
                f"{path}: artifact integrity check failed — "
                f"corrupt/missing arrays {bad[:4]}"
                + (f", unmanifested arrays {extra[:4]}" if extra else ""))
    cache: Dict[str, torch.Tensor] = {}

    def build(spec):
        kind = spec["kind"]
        if kind == "dict":
            return {k: build(v) for k, v in spec["items"].items()}
        if kind in ("list", "tuple"):
            seq = [build(v) for v in spec["items"]]
            return seq if kind == "list" else tuple(seq)
        key = spec.get("alias", spec["key"])
        if key not in cache:
            if key not in arrays:
                raise KeyError(f"artifact missing array {key}")
            cache[key] = _from_numpy(arrays[key]).to(
                device=dev, dtype=getattr(torch, spec["dtype"]))
        return cache[key]

    return build(manifest["structure"]), manifest["meta"]


def artifact_fingerprint(ckpt_dir: str, name: str = "pytree") -> str:
    """Stable identity of a saved pytree artifact: sha256 over the
    manifest's per-array content hashes (falling back to the raw manifest
    bytes for pre-hashing artifacts). Byte-identical arrays fingerprint
    identically; any content change — re-save with other values, bit flip,
    different ranks — changes it."""
    path = os.path.join(ckpt_dir, name)
    with open(os.path.join(path, "manifest.json"), "rb") as f:
        raw = f.read()
    manifest = json.loads(raw)
    h = hashlib.sha256()
    hashes = manifest.get("hashes")
    if hashes:
        for k in sorted(hashes):
            h.update(k.encode())
            h.update(hashes[k].encode())
    else:
        h.update(raw)
    return h.hexdigest()


def quarantine_artifact(ckpt_dir: str, name: str = "pytree") -> str:
    """Move a failing artifact aside so nothing boots from it again and a
    re-push/re-save can land cleanly at the original path. Returns the
    quarantine path (``<name>.quarantined[-N]``, first free suffix)."""
    src = os.path.join(ckpt_dir, name)
    dst = src + ".quarantined"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{src}.quarantined-{n}"
    os.rename(src, dst)
    return dst


def load_pytree_resilient(ckpt_dir: str, name: str = "pytree",
                          verify: bool = True, retries: int = 2,
                          backoff_s: float = 0.05, quarantine: bool = True,
                          device: DeviceLike = None) -> Tuple[Any, Dict]:
    """``load_pytree`` with retry-with-backoff and poison quarantine.

    Transient failures (a reader racing an atomic re-save) heal on retry;
    persistent ones (bit flips, truncation — anything the sha256 manifest
    check or the zip layer rejects) do not. After ``retries`` failed
    re-reads the artifact directory is moved to ``<name>.quarantined``
    (unless ``quarantine=False``) and the last error is raised as an
    ``IntegrityError``, so a supervisor loop never boot-loops on a poisoned
    artifact and the bytes stay on disk for forensics."""
    import zipfile
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        # a missing artifact is a config error, not corruption: no retry,
        # no quarantine, and the caller sees the standard exception
        raise FileNotFoundError(
            f"no artifact directory {os.path.join(ckpt_dir, name)}")
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        if attempt:
            time.sleep(backoff_s * (2 ** (attempt - 1)))
        try:
            return load_pytree(ckpt_dir, name=name, verify=verify,
                               device=device)
        except (IntegrityError, OSError, zipfile.BadZipFile,
                json.JSONDecodeError, KeyError) as e:
            last = e
    where = os.path.join(ckpt_dir, name)
    if quarantine and os.path.exists(where):
        where = quarantine_artifact(ckpt_dir, name)
    raise IntegrityError(
        f"artifact {os.path.join(ckpt_dir, name)} failed to load after "
        f"{retries + 1} attempts"
        + (f"; quarantined at {where}" if quarantine else "")
        + f" — last error: {last}") from last


class AsyncCheckpointer:
    """Single worker thread; the newest pending save wins (drop stale).

    ``submit`` copies every tensor to the host before it returns
    (``.detach().to("cpu", copy=True)``: a CPU tensor gets its own copy
    too), so a later in-place update of the caller's tensors cannot reach
    the values the worker writes."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, meta = item
            try:
                save(self.ckpt_dir, step, host_tree, meta, self.keep_last)
            except BaseException as e:          # surfaced on next submit
                self._err = e

    def submit(self, step: int, tree, meta: Optional[Dict] = None) -> None:
        if self._err:
            raise self._err
        host = pytree.tree_map(
            lambda t: (t.detach().to("cpu", copy=True)
                       if isinstance(t, torch.Tensor) else np.array(t)),
            tree)
        try:                                     # drop an unstarted stale save
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._q.put((step, host, meta))

    def close(self, timeout: float = 60.0) -> None:
        self._q.put(None)
        self._thread.join(timeout=timeout)
        if self._err:
            raise self._err
