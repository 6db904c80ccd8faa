"""Template-free pytree artifacts: the ``pytree_v1`` format (counterpart of
the template-free half of ``repro/ckpt/store.py``).

Layout of an artifact ``<dir>/<name>/``:

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

The step checkpoints (``save``/``restore``) and the asynchronous
checkpointer of the JAX module come with training (ROADMAP Queue 1,
item 9).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

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
            cache[key] = torch.from_numpy(np.ascontiguousarray(
                arrays[key])).to(device=dev,
                                 dtype=getattr(torch, spec["dtype"]))
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
