"""Serving: batched prefill + single-token decode steps (counterpart of the
fixed-batch ``Engine`` of ``repro/serve/engine.py``).

``Engine.generate`` prefills a batch of same-length prompts into a
preallocated KV cache and runs the greedy (or sampled) decode loop; every
compressed linear goes through the low-rank kernels and every attention
through the flash and decode kernels on the card. ``Engine.from_compressed``
boots from a ``compress.save_plan`` artifact of either package. The
continuous batcher and the resilience layer come in later slices (ROADMAP
Queue 1, item 6).

Two departures from the JAX engine, both deterministic:

* the KV cache is preallocated once per call and updated in place by index
  assignment (``models.attention.attend_decode``), where JAX returns a new
  cache from a functional ``.at[].set``;
* the linear weights and the embedding are cast to the compute dtype once,
  at construction, where JAX casts them inside every ``apply_linear`` call.
  The cast is the same rounding either way; doing it once keeps a decode
  step from reading float32 weights only to round them again. Norm scales
  stay as they are, as JAX reads them.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.params import Params

# leaves cast to the compute dtype at construction
_CAST_KEYS = frozenset({"w", "B", "C", "b", "embed", "lora_A", "lora_B"})


@dataclass(frozen=True)
class ServeConfig:
    batch: int = 8                # decode slot count
    max_len: int = 512            # cache capacity (prompt + generated)
    temperature: float = 0.0      # 0 => greedy
    seed: int = 0
    # --- paged KV pool (not ported yet) ----------------------------------
    kv_block: int = 0             # KV block size in tokens; 0 = contiguous
    prefix_cache: bool = False    # share identical prompt-prefix blocks


def place_params(params: Params, dtype: torch.dtype,
                 device: torch.device) -> Params:
    """Params on ``device`` with the linear weights and the embedding in
    ``dtype``. Tensors shared between layers (a group's shared basis) stay
    shared."""
    memo: Dict[int, torch.Tensor] = {}

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, torch.Tensor):
            if id(node) not in memo:
                cast = dtype if key in _CAST_KEYS else node.dtype
                memo[id(node)] = node.to(device=device, dtype=cast)
            return memo[id(node)]
        return node

    return walk(params)


def _normalize_load_retries(retries, load_retries: int) -> int:
    """Fold the older ``retries=`` spelling into ``load_retries=`` with a
    deprecation warning."""
    if retries is not None:
        warnings.warn(
            "from_compressed(retries=...) is deprecated; use "
            "load_retries=...", DeprecationWarning, stacklevel=3)
        return int(retries)
    return load_retries


def from_compressed(ckpt_dir: str, cfg: ModelConfig,
                    scfg: Optional[ServeConfig] = None, *,
                    batcher: bool = True, verify: bool = False,
                    load_retries: int = 0,
                    quarantine: Optional[bool] = None,
                    device: DeviceLike = None):
    """THE loading path for booting a serve engine from a
    ``compress.save_plan`` artifact (``Engine.from_compressed`` delegates
    here).

    ``verify=True`` re-hashes the stored arrays against the manifest
    content hashes before booting; ``load_retries > 0`` retries a
    transiently failing load with backoff and (with ``quarantine``,
    default: on whenever retries are) moves a persistently failing
    artifact aside before raising a typed ``store.IntegrityError``.
    ``batcher=False`` returns the fixed-batch :class:`Engine`; the
    continuous batcher (the JAX default) is not ported yet. The params are
    loaded onto ``device`` (the card by default) and the engine runs
    there; ``engine.plan`` holds the artifact's allocation plan.
    """
    if batcher:
        raise NotImplementedError(
            "the ContinuousBatcher is not ported yet (ROADMAP Queue 1, item "
            "6); pass batcher=False for the fixed-batch Engine")
    from repro_torch.core import compress as CC
    if quarantine is None:
        quarantine = load_retries > 0
    dev = resolve_device(device)
    params, plan = CC.load_plan(ckpt_dir, cfg=cfg, verify=verify,
                                retries=load_retries, quarantine=quarantine,
                                device=dev)
    eng = Engine(params, cfg, scfg if scfg is not None else ServeConfig(),
                 device=dev)
    eng.plan = plan
    return eng


class Engine:
    def __init__(self, params: Params, cfg: ModelConfig, scfg: ServeConfig,
                 device: DeviceLike = None):
        T.check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scfg = scfg
        self.plan = None              # set when booted from a compressed ckpt
        self.params = place_params(params, T.dtype_of(cfg.dtype), self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(scfg.seed)

    @classmethod
    def from_compressed(cls, ckpt_dir: str, cfg: ModelConfig,
                        scfg: ServeConfig, verify: bool = False,
                        retries: Optional[int] = None,
                        load_retries: int = 0,
                        quarantine: Optional[bool] = None,
                        device: DeviceLike = None) -> "Engine":
        """Boot directly from a ``compress.save_plan`` artifact of either
        package — no calibration or SVD at serve time; the factorized
        list-form params drop straight into the model code. Delegates to
        the module-level :func:`from_compressed`. ``verify=True`` re-hashes
        the stored arrays first; ``load_retries``/``quarantine`` retry a
        transiently failing load and move a persistently failing artifact
        aside; ``retries=`` is the older spelling of ``load_retries=``.
        """
        return from_compressed(
            ckpt_dir, cfg, scfg, batcher=False, verify=verify,
            load_retries=_normalize_load_retries(retries, load_retries),
            quarantine=quarantine, device=device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- batch generation (simple API, fixed same-length prompts) --------
    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, n_new: int) -> np.ndarray:
        """prompts: (B, S) int. Returns (B, n_new) int32."""
        tokens = torch.as_tensor(np.asarray(prompts), device=self.device)
        max_len = tokens.shape[1] + n_new + 1
        logits, cache = T.prefill(self.params, self.cfg, {"tokens": tokens},
                                  max_len=max_len)
        outs = []
        tok = self._sample(logits)
        for _ in range(n_new):
            outs.append(tok)
            logits, cache = T.decode_step(self.params, self.cfg, cache, tok)
            tok = self._sample(logits)
        return torch.cat(outs, dim=1).cpu().numpy()

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.scfg.temperature <= 0:
            return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        probs = torch.softmax(logits[:, -1].float() / self.scfg.temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator
                                 ).to(torch.int32)

    # ---- throughput measurement (Fig. 4 benchmark) ------------------------
    @torch.inference_mode()
    def measure_decode_throughput(self, batch: int, prompt_len: int,
                                  n_new: int, warmup: int = 3
                                  ) -> Dict[str, float]:
        """Greedy decode of ``n_new`` steps after a prefill of ``batch``
        random prompts; the host clock runs between two device
        synchronizations around the timed loop."""
        prompts = np.random.default_rng(0).integers(
            0, self.cfg.vocab_size, size=(batch, prompt_len), dtype=np.int32)
        tokens = torch.as_tensor(prompts, device=self.device)
        logits, cache = T.prefill(self.params, self.cfg, {"tokens": tokens},
                                  max_len=prompt_len + warmup + n_new + 1)
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        # warmup advances the cache (each step decodes a fresh position,
        # like the timed loop) and is safely skippable with warmup=0
        for _ in range(warmup):
            logits, cache = T.decode_step(self.params, self.cfg, cache, tok)
            tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(n_new):
            logits, cache = T.decode_step(self.params, self.cfg, cache, tok)
            tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        self._sync()
        dt = time.perf_counter() - t0
        return {"tokens_per_s": batch * n_new / dt,
                "ms_per_step": dt / n_new * 1000.0}
