"""Serving: prefill + single-token decode steps, the fixed-batch ``Engine``
and the slot-based ``ContinuousBatcher`` with its resilience layer
(counterpart of ``repro/serve/engine.py``; DESIGN.md §5).

``Engine.generate`` prefills a batch of same-length prompts into a
preallocated KV cache and runs the greedy (or sampled) decode loop; every
compressed linear goes through the low-rank kernels and every attention
through the flash and decode kernels on the card. The ``ContinuousBatcher``
keeps ``batch`` decode slots over a contiguous per-slot pool or, with
``ServeConfig.kv_block > 0``, a paged block arena with optional prefix
reuse (copy-on-write forks), admits waiting requests in bucketed batched
prefills, and steps every live slot each iteration. Its resilience layer
is the JAX one: bounded admission with deadlines, a host finite guard on
every logits row with bisection and quarantine of poisoned requests, the
elastic rank ladder, a watchdog on the drain, fault injection
(``dist.faultinject.FaultPlan``), tracing spans and a flight recorder.
``from_compressed`` boots either from a ``compress.save_plan`` artifact
of either package.

Departures from the JAX engine, all deterministic:

* the KV cache is preallocated once and updated in place by index
  assignment (``models.attention.attend_decode``, ``serve.aot``'s row
  functions), where JAX returns a new cache from a functional
  ``.at[].set``; the batcher's prefill (and so the poison probe) still
  builds a fresh cache and never touches the pool;
* the linear weights, the MoE expert stacks and the embedding are cast to
  the compute dtype once, at construction, where JAX casts them inside
  every ``apply_linear`` and expert product.
  The cast is the same rounding either way; doing it once keeps a decode
  step from reading float32 weights only to round them again. Norm scales
  stay as they are, as JAX reads them;
* the batcher keeps its next-token column on the host and hands it to the
  registry, which uploads it for each decode step (into a captured graph's
  static buffer with ``serve.aot.AotRegistry``); the finite guard reads
  each step's last logits on the host, as JAX does.
"""
from __future__ import annotations

import dataclasses
import json
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.params import Params
from repro_torch.obs import flightrec as frec
from repro_torch.obs import trace
from repro_torch.serve import admission as adm
from repro_torch.serve import aot as aotlib

# leaves cast to the compute dtype at construction; ``w_gate``, ``w_up`` and
# ``w_down`` name tensors only in an MoE layer's dense (E, d, f) expert
# stacks (elsewhere they are linear dicts, walked into)
_CAST_KEYS = frozenset({"w", "B", "C", "b", "embed", "lora_A", "lora_B",
                        "w_gate", "w_up", "w_down"})


@dataclass(frozen=True)
class ServeConfig:
    batch: int = 8                # decode slot count
    max_len: int = 512            # cache capacity (prompt + generated)
    temperature: float = 0.0      # 0 => greedy
    seed: int = 0
    # --- paged KV pool (DESIGN.md §5.7) -----------------------------------
    kv_block: int = 0             # KV block size in tokens; 0 = contiguous
    #                               per-slot pool
    prefix_cache: bool = False    # share identical prompt-prefix blocks
    #                               across requests (requires kv_block > 0)


@dataclass
class Request:
    rid: int
    tokens: np.ndarray            # prompt (S,)
    n_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_done: float = 0.0
    # --- resilience fields (serve.admission / quarantine) -----------------
    deadline_s: Optional[float] = None   # relative to submit; None = none
    status: str = adm.QUEUED
    retries: int = 0              # poison-quarantine attempts consumed
    t_admit: float = 0.0
    t_first: float = 0.0          # first token emitted (TTFT anchor)
    error: Optional[str] = None   # set on typed failure
    truncated: bool = False       # prompt lost its oldest tokens at
    #                               admission (over max_len - 1)


class DrainResult(list):
    """``run_until_drained`` result: the list of completed requests plus
    the drain verdict.

    ``status`` is ``"drained"`` (queue empty, all slots free),
    ``"timeout"`` (``max_steps`` exhausted with work still pending) or
    ``"stalled"`` (the watchdog saw no forward progress — tokens, shed or
    terminal transitions — for ``watchdog_s``). ``undrained`` lists the
    requests still queued or running; ``shed``/``rejected``/``failed``
    surface the terminal non-success populations."""

    def __init__(self, done: List[Request], status: str,
                 undrained: List[Request], shed: List[Request],
                 rejected: List[Request], failed: List[Request]):
        super().__init__(done)
        self.status = status
        self.undrained = undrained
        self.shed = shed
        self.rejected = rejected
        self.failed = failed


def place_params(params: Params, dtype: torch.dtype,
                 device: torch.device) -> Params:
    """Params on ``device`` with the linear weights, the MoE expert stacks
    and the embedding in ``dtype``. Tensors shared between layers (a
    group's shared basis) stay shared."""
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
                    device: DeviceLike = None, **kwargs):
    """THE loading path for booting a serve engine from a
    ``compress.save_plan`` artifact of either package
    (``Engine.from_compressed`` and ``ContinuousBatcher.from_compressed``
    delegate here).

    ``verify=True`` re-hashes the stored arrays against the manifest
    content hashes before booting; ``load_retries > 0`` retries a
    transiently failing load with backoff and (with ``quarantine``,
    default: on whenever retries are) moves a persistently failing
    artifact aside before raising a typed ``store.IntegrityError``.
    Returns the :class:`ContinuousBatcher` by default, as the JAX package
    does, or with ``batcher=False`` the fixed-batch :class:`Engine`; extra
    kwargs (``admission``, ``faults``, ``heartbeat``, ``executables``,
    ``flight``) pass through to the batcher. The params are loaded onto
    ``device`` (the card by default) and the engine runs there;
    ``engine.plan`` holds the artifact's allocation plan.
    """
    from repro_torch.core import compress as CC
    if quarantine is None:
        quarantine = load_retries > 0
    dev = resolve_device(device)
    params, plan = CC.load_plan(ckpt_dir, cfg=cfg, verify=verify,
                                retries=load_retries, quarantine=quarantine,
                                device=dev)
    scfg = scfg if scfg is not None else ServeConfig()
    cls = ContinuousBatcher if batcher else Engine
    eng = cls(params, cfg, scfg, device=dev, **kwargs)
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
    def generate(self, prompts: np.ndarray, n_new: int,
                 lengths: Optional[np.ndarray] = None,
                 enc_embeds: Optional[np.ndarray] = None) -> np.ndarray:
        """prompts: (B, S) int; ``lengths`` (B,) int, optional: row b's
        prompt is its first lengths[b] tokens (right-padded), as
        ``T.prefill`` takes them; a stack with recurrent layers refuses it
        (the padding would run through the state). ``enc_embeds`` (B, T,
        D): an encoder-decoder model's encoder input (the audio stub).
        Returns (B, n_new) int32."""
        if lengths is not None and T.is_recurrent(self.cfg):
            raise ValueError(
                f"{self.cfg.name}: generate(lengths=...) right-pads prompts, "
                f"which corrupts recurrent state; pass equal-length prompts "
                f"(or serve through the ContinuousBatcher)")
        tokens = torch.as_tensor(np.asarray(prompts), device=self.device)
        max_len = tokens.shape[1] + n_new + 1
        batch = {"tokens": tokens}
        if lengths is not None:
            batch["lengths"] = torch.as_tensor(np.asarray(lengths),
                                               device=self.device)
        if enc_embeds is not None:
            batch["enc_embeds"] = torch.as_tensor(np.asarray(enc_embeds),
                                                  device=self.device)
        logits, cache = T.prefill(self.params, self.cfg, batch,
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
        random prompts (an encoder-decoder model's encoder reads zero
        ``enc_embeds`` of ``prompt_len`` frames, as in JAX); the host clock
        runs between two device synchronizations around the timed loop."""
        prompts = np.random.default_rng(0).integers(
            0, self.cfg.vocab_size, size=(batch, prompt_len), dtype=np.int32)
        b = {"tokens": torch.as_tensor(prompts, device=self.device)}
        if self.cfg.is_encoder_decoder:
            b["enc_embeds"] = torch.zeros(
                (batch, prompt_len, self.cfg.d_model), dtype=torch.float32,
                device=self.device)
        logits, cache = T.prefill(self.params, self.cfg, b,
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


def _bucket_len(n: int, max_len: int) -> int:
    """Next power of two ≥ n (floor 2), capped at max_len. Bucketing prompt
    pads means the prefill sees at most ⌈log2(max_len)⌉ shapes instead of
    one per distinct prompt length."""
    b = 2
    while b < n:
        b *= 2
    return min(b, max_len)


class ContinuousBatcher:
    """Slot-based continuous batching on top of per-slot caches.

    Every slot owns one row of a persistent batched cache (or, paged, a
    row of the block table); decode advances all live slots each step.
    Admission is BATCHED: all waiting requests that fit into free slots
    are prefilled together in one fixed-batch call, with prompts
    right-padded to a power-of-two bucket (per-row ``lengths`` keep ragged
    rows exact: padded cache slots are zeroed and masked). The freshly
    built rows then land in the pool through a single multi-row scatter.
    The registry counts the distinct prefill/decode/scatter signatures in
    ``stats``; the bucketing invariant (≤ ⌈log2(max_len)⌉ prefill
    signatures, 1 decode signature per rung) is asserted in tests.

    Architectures with recurrent state (Hymba, xLSTM) cannot be
    right-padded: they take the exact-length path, one single-row prefill
    per request at its prompt's exact length (one prefill signature per
    distinct length) scattered into its slot, every state leaf included.
    Such stacks have no paged pool (``kv_block > 0`` raises).

    The batcher serves decoder-only stacks: an encoder-decoder model
    raises ``ValueError`` at construction (the JAX batcher's admission
    passes no encoder input and fails on the first request; serve one
    through ``Engine.generate(enc_embeds=...)``). Under M-RoPE, prefix
    reuse raises too: the JAX reference's tail prefill cannot build
    M-RoPE positions.
    """

    @classmethod
    def from_compressed(cls, ckpt_dir: str, cfg: ModelConfig,
                        scfg: ServeConfig, verify: bool = False,
                        retries: Optional[int] = None,
                        load_retries: int = 0,
                        quarantine: Optional[bool] = None,
                        device: DeviceLike = None,
                        **kwargs) -> "ContinuousBatcher":
        """Boot the batcher from a saved compressed checkpoint. Delegates
        to the module-level :func:`from_compressed` (``verify`` checks
        content hashes, ``load_retries``/``quarantine`` make the load
        resilient; ``retries=`` is the older spelling). Extra kwargs
        (``admission``, ``faults``, ``heartbeat``, ``executables``,
        ``flight``) pass through to the constructor."""
        return from_compressed(
            ckpt_dir, cfg, scfg, batcher=True, verify=verify,
            load_retries=_normalize_load_retries(retries, load_retries),
            quarantine=quarantine, device=device, **kwargs)

    def __init__(self, params: Params, cfg: ModelConfig, scfg: ServeConfig,
                 admission: Optional[adm.AdmissionConfig] = None,
                 faults=None, heartbeat=None, executables=None,
                 flight: Optional[frec.FlightRecorder] = None,
                 device: DeviceLike = None):
        T.check_supported(cfg)
        if cfg.is_encoder_decoder:
            raise ValueError(
                f"{cfg.name}: the ContinuousBatcher serves decoder-only "
                f"stacks; its admission passes no encoder input (the JAX "
                f"reference's exact-length admission passes only tokens and "
                f"fails with KeyError 'enc_tokens'); use "
                f"Engine.generate(enc_embeds=...)")
        if scfg.prefix_cache and cfg.rope_kind == "mrope":
            raise ValueError(
                f"{cfg.name}: prefix_cache under M-RoPE is not served: the "
                f"tail prefill builds (B, S) positions where M-RoPE takes "
                f"(3, B, S), and the JAX reference fails there too")
        self.device = resolve_device(device)
        self.params = place_params(params, T.dtype_of(cfg.dtype),
                                   self.device)
        self.cfg, self.scfg = cfg, scfg
        self.plan = None
        self.acfg = admission or adm.AdmissionConfig()
        self.faults = faults          # dist.faultinject.FaultPlan or None
        self.heartbeat = heartbeat    # anything with .beat(step), or None
        # always-on event ring; only writes when flight.dump_dir is set
        self.flight = flight if flight is not None else frec.FlightRecorder()
        kinds = {k for k, _ in cfg.layer_runs()}
        self.bucketed = kinds <= {"attn", "swa"}
        # --- paged KV pool (DESIGN.md §5.7) -------------------------------
        self.paged = scfg.kv_block > 0
        if scfg.prefix_cache and not self.paged:
            raise ValueError("prefix_cache requires kv_block > 0")
        if self.paged:
            if scfg.max_len % scfg.kv_block:
                raise ValueError(
                    f"kv_block={scfg.kv_block} must divide "
                    f"max_len={scfg.max_len}")
            if kinds != {"attn"}:
                raise ValueError(
                    "paged KV cache requires a pure-attention decoder "
                    f"(got layer kinds {sorted(kinds)})")
            from repro_torch.serve import paged as pglib
            self.nb = scfg.max_len // scfg.kv_block
            # worst case every slot holds a full-length row, +1 for the
            # reserved null block: without prefix sharing allocation can
            # never fail; sharing only frees headroom
            self.n_blocks = scfg.batch * self.nb + 1
            self.cache = T.init_cache_paged(cfg, scfg.batch, self.n_blocks,
                                            scfg.kv_block, self.device)
            self.pool = pglib.BlockPool(self.n_blocks)
            self.prefix = (pglib.PrefixCache(scfg.kv_block)
                           if scfg.prefix_cache else None)
            self.table = np.zeros((scfg.batch, self.nb), dtype=np.int32)
            self._table_dev: Optional[torch.Tensor] = None   # device copy
            self._req_blocks: Dict[int, tuple] = {}  # rid -> (held, nshared)
        else:
            self.cache = T.init_cache(cfg, scfg.batch, scfg.max_len,
                                      self.device)
        self.slots: List[Optional[Request]] = [None] * scfg.batch
        # next-token column, kept on the host and uploaded per decode step
        self.tokens = np.zeros((scfg.batch, 1), dtype=np.int32)
        self.done: List[Request] = []
        self.failed: List[Request] = []
        self._metrics = adm.ServeMetrics()
        self.admission = adm.AdmissionController(self.acfg, self._metrics)
        self._step_idx = 0
        self._progress = 0            # bumps on any forward progress
        # streaming hooks: called on the engine thread as tokens are
        # emitted / requests reach terminal states / a quarantine rewinds
        # a request's output
        self.on_token: Optional[Callable[[Request, int], None]] = None
        self.on_terminal: Optional[Callable[[Request], None]] = None
        self.on_rewind: Optional[Callable[[Request], None]] = None
        # elastic-rank ladder: rung 0 is self.params ITSELF (token-identical
        # to the engine without a ladder); rung ℓ slices the singular-value-
        # ordered factors to the pow2 bucket pow2_ceil(k) >> ℓ. Dense
        # params have no factors to slice: the ladder stays length 1.
        self.level = 0
        if self.acfg.elastic:
            from repro_torch.core.compress import slice_rank_ladder
            self.ladder = slice_rank_ladder(self.params,
                                            levels=self.acfg.elastic_levels)
            if len(self.ladder) > 1 and self.ladder[1] is self.params:
                self.ladder = [self.params]
        else:
            self.ladder = [self.params]
        self.stats: Dict[str, int] = {
            "prefill_retraces": 0, "decode_retraces": 0,
            "scatter_retraces": 0, "admissions": 0, "admitted": 0,
        }
        # executable registry: all prefill/decode/scatter/purge dispatch
        # goes through one object (serve/aot.py)
        self.exec = executables if executables is not None \
            else aotlib.TracedRegistry(cfg, scfg)
        self.exec.bind_stats(self.stats)

    def warm_executables(self) -> None:
        """Make the whole serving surface for this batcher's ladder up
        front: a no-op for the traced registry; for an ``AotRegistry`` the
        boot step that captures every decode and prefill graph on the
        still-empty pool, so the steady-state loop only replays (see
        ``repro_torch.serve.api.load_engine``)."""
        self.exec.warm(self.ladder, self.bucketed, paged=self.paged,
                       pool=self.cache)

    # ---- streaming emission (hooks) --------------------------------------
    def _emit_token(self, req: Request, tok: int) -> None:
        if self.on_token is not None:
            self.on_token(req, tok)

    def _emit_terminal(self, req: Request) -> None:
        trace.async_end("request", req.rid, status=req.status)
        if self.on_terminal is not None:
            self.on_terminal(req)

    def _emit_rewind(self, req: Request) -> None:
        if self.on_rewind is not None:
            self.on_rewind(req)

    # ---- intake ----------------------------------------------------------
    @property
    def queue(self) -> List[Request]:
        return self.admission.queue

    def submit(self, req: Request) -> bool:
        """Offer a request. Returns True iff admitted to the wait queue;
        False means backpressure (queue at ``max_queue``: the request is
        marked ``shed_queue_full`` and kept in ``admission.rejected``)."""
        trace.async_begin("request", req.rid, n_new=req.n_new,
                          prompt_len=len(req.tokens))
        ok = self.admission.offer(req, time.perf_counter())
        if not ok:
            trace.async_end("request", req.rid, status=req.status)
            self.flight.note("reject", rid=req.rid, status=req.status)
        return ok

    def _params_now(self) -> Params:
        return self.ladder[self.level]

    def _adjust_rank_level(self) -> None:
        depth = len(self.queue)
        prev = self.level
        if (depth >= self.acfg.degrade_above
                and self.level < len(self.ladder) - 1):
            self.level += 1
        elif depth <= self.acfg.restore_below and self.level > 0:
            self.level -= 1
        if self.level != prev:
            trace.instant("rung_transition", frm=prev, to=self.level,
                          queue_depth=depth)
            self.flight.note("rung", frm=prev, to=self.level,
                             queue_depth=depth, step=self._step_idx)

    # ---- admission -------------------------------------------------------
    def _admit(self) -> None:
        free = [i for i, r in enumerate(self.slots) if r is None]
        admit, shed = self.admission.take(len(free), time.perf_counter())
        for req in shed:
            self.flight.note("shed", rid=req.rid, status=req.status)
            self._emit_terminal(req)
        admit = [r for r in admit if self._check_length(r)]
        if not admit:
            return
        with trace.span("admit", n=len(admit), level=self.level):
            self.flight.note("admit", rids=[r.rid for r in admit],
                             level=self.level)
            if self.paged:
                n_adm = self._admit_paged(admit, free[:len(admit)])
            elif self.bucketed:
                self._admit_batched(admit, free[:len(admit)])
                n_adm = len(admit)
            else:
                for req, slot in zip(admit, free):
                    self._admit_exact(req, slot)
                n_adm = len(admit)
        self.stats["admissions"] += 1
        self.stats["admitted"] += n_adm

    def _check_length(self, req: Request) -> bool:
        """Over-long prompt policy at admission. Cache rows hold prompt +
        generated tokens, so a prompt keeps at most ``max_len - 1``
        tokens. Default: keep the NEWEST tokens, counted, flight-recorded
        and flagged on the request. With
        ``AdmissionConfig.reject_overlong`` the request is shed typed
        (``shed_overlong``) before it wastes a prefill."""
        keep = self.scfg.max_len - 1
        n = len(req.tokens)
        if n <= keep:
            return True
        if self.acfg.reject_overlong:
            req.status = adm.SHED_OVERLONG
            self._metrics.bump("shed_overlong")
            self.admission.shed.append(req)
            self.flight.note("shed", rid=req.rid, status=req.status,
                             prompt_len=n, max_len=self.scfg.max_len)
            self._emit_terminal(req)
            self._progress += 1          # terminal transition
            return False
        req.tokens = req.tokens[-keep:]
        req.truncated = True
        self._metrics.bump("prompt_truncations")
        self.flight.note("truncate", rid=req.rid, kept=keep,
                         dropped=n - keep)
        return True

    def _poison_rid_rows(self, reqs: Sequence[Optional[Request]],
                         last: np.ndarray) -> None:
        """Persistent content-poison injection (FaultPlan.poison_rids):
        corrupt the host-side logits row of marked requests."""
        if self.faults is None:
            return
        for j, req in enumerate(reqs):
            if req is not None and self.faults.rid_is_poison(req.rid):
                last[j] = np.nan

    @staticmethod
    def _last_logits(logits: torch.Tensor) -> np.ndarray:
        """(B, V) writable float32 host copy of the last position's logits:
        the host finite guard's input (bf16 widens exactly). A graph
        registry's logits are its output buffer, which the next replay
        overwrites: this copy is taken right after the call."""
        return logits[:, -1].float().cpu().numpy()

    def _set_tokens(self, slots: np.ndarray, toks: np.ndarray) -> None:
        """tokens[slots[j]] = toks[j]; a slot >= batch is padding."""
        keep = slots < self.scfg.batch
        self.tokens[slots[keep], 0] = toks[keep]

    def _admit_batched(self, admit: List[Request], free: List[int]) -> None:
        """All admitted prompts in ONE fixed-batch bucketed prefill,
        emitted through the finite guard."""
        B = self.scfg.batch
        Sb = _bucket_len(max(len(r.tokens) for r in admit),
                         self.scfg.max_len)
        toks = np.zeros((B, Sb), dtype=np.int32)
        lens = np.ones((B,), dtype=np.int32)
        slots = np.full((B,), B, dtype=np.int32)       # B = dropped row
        for j, (req, slot) in enumerate(zip(admit, free)):
            toks[j, :len(req.tokens)] = req.tokens
            lens[j] = len(req.tokens)
            slots[j] = slot
        with trace.span("prefill", bucket=Sb, n=len(admit),
                        level=self.level):
            logits, c1 = self.exec.prefill(
                self._params_now(), {"tokens": toks, "lengths": lens},
                level=self.level, bucket=Sb)
            self.cache = self.exec.scatter(self.cache, c1, slots)
        last = self._last_logits(logits)
        if self.faults is not None:
            for j in self.faults.prefill_rows_to_poison(
                    self.stats["admissions"], len(admit)):
                last[j] = np.nan
        self._poison_rid_rows(admit + [None] * (B - len(admit)), last)
        finite = np.isfinite(last).all(axis=-1)
        tok = last.argmax(-1).astype(np.int32)
        tok[~finite] = 0
        self._set_tokens(slots, tok)
        bad: List[int] = []
        now = time.perf_counter()
        for j, (req, slot) in enumerate(zip(admit, free)):
            if finite[j]:
                req.out.append(int(tok[j]))
                self._emit_token(req, int(tok[j]))
                req.t_first = req.t_first or now
                self._metrics.observe_ttft(now - req.t_submit)
                self.slots[slot] = req
                self._progress += 1
            else:
                bad.append(j)
        if bad:
            ambiguous = len(bad) == len(admit) and len(admit) > 1
            self._purge_slots([free[j] for j in bad])
            self._quarantine([admit[j] for j in bad], ambiguous)

    def _admit_exact(self, req: Request, slot: int) -> None:
        """Exact-length single-row admission (recurrent-state stacks): a
        one-row prefill at the prompt's own length, scattered into the
        slot, then the finite guard on its logits (a poisoned row is
        purged and quarantined) and the first token."""
        with trace.span("prefill", exact=len(req.tokens),
                        level=self.level):
            logits, c1 = self.exec.prefill(
                self._params_now(),
                {"tokens": np.asarray(req.tokens, dtype=np.int32)[None, :]},
                level=self.level)
            self.cache = self.exec.scatter(
                self.cache, c1, np.asarray([slot], dtype=np.int32))
        last = self._last_logits(logits)
        self._poison_rid_rows([req], last)
        if not np.isfinite(last[0]).all():
            self._purge_slots([slot])
            self._quarantine([req], ambiguous=False)
            return
        t = int(last[0].argmax())
        req.out.append(t)
        self._emit_token(req, t)
        now = time.perf_counter()
        req.t_first = req.t_first or now
        self._metrics.observe_ttft(now - req.t_submit)
        self.tokens[slot, 0] = t
        self.slots[slot] = req
        self._progress += 1

    # ---- paged admission (DESIGN.md §5.7) --------------------------------
    def _table_device(self) -> torch.Tensor:
        """The block table on the device, copied once per host change:
        every host edit of ``self.table`` (admission, CoW fork, release,
        purge) drops the copy, since a stale table is a silent wrong
        answer. A graph registry copies it into its decode entry's static
        buffer only when this copy is a new one."""
        if self._table_dev is None:
            self._table_dev = torch.as_tensor(self.table.copy(),
                                              device=self.device)
        return self._table_dev

    def _kv_gauges(self) -> None:
        r = self._metrics.registry
        r.gauge("kv_blocks_in_use").set(self.pool.in_use)
        r.gauge("kv_blocks_peak").set(self.pool.peak_in_use)

    def _admit_paged(self, admit: List[Request], free: List[int]) -> int:
        """Paged admission: plan each request against the prefix cache,
        allocate and refcount its blocks into a table row, CoW-fork
        partial matches, then prefill in (at most) two fixed-batch groups
        (fresh rows through the plain bucketed prefill, prefix-extending
        rows through ``prefill_ext``) and route both results into the
        arena with the table-indirected scatter. Requests the pool can't
        hold (only possible with prefix sharing pinning blocks) requeue at
        the front. Returns the number actually admitted."""
        B = self.scfg.batch
        bk = self.scfg.kv_block
        plans: List[tuple] = []           # (req, slot, start)
        cow_src: List[int] = []
        cow_dst: List[int] = []
        deferred: List[Request] = []
        for req, slot in zip(admit, free):
            if deferred:                  # keep FIFO: defer the rest too
                deferred.append(req)
                continue
            n = len(req.tokens)
            need = -(-min(n + req.n_new, self.scfg.max_len) // bk)
            plan = (self.prefix.plan(req.tokens)
                    if self.prefix is not None else None)
            shared = plan.shared if plan is not None else []
            n_alloc = need - len(shared)
            if self.prefix is not None:
                while not self.pool.can_alloc(n_alloc):
                    if not self.prefix.evict_lru(self.pool):
                        break
                    self._metrics.bump("prefix_evictions")
            fresh = self.pool.alloc(n_alloc)
            if fresh is None:
                deferred.append(req)
                continue
            held = [e.block for e in shared]
            for b in held:
                self.pool.incref(b)
            held.extend(fresh)
            row = np.zeros((self.nb,), dtype=np.int32)
            row[:len(held)] = held
            self.table[slot] = row
            start = 0
            if plan is not None:
                start = plan.start
                if plan.cow_src:
                    cow_src.append(plan.cow_src)
                    cow_dst.append(fresh[0])
                    self._metrics.bump("cow_forks")
                self._metrics.bump(
                    "prefix_hits" if start > 0 else "prefix_misses")
            self._req_blocks[req.rid] = (held, len(shared))
            plans.append((req, slot, start))
        for req in reversed(deferred):
            self.admission.requeue(req)
        if not plans:
            return 0
        self._table_dev = None
        self._kv_gauges()
        if cow_src:
            src = np.full((B,), self.n_blocks, dtype=np.int32)
            dst = np.full((B,), self.n_blocks, dtype=np.int32)
            src[:len(cow_src)] = cow_src
            dst[:len(cow_dst)] = cow_dst
            self.cache = self.exec.copy_blocks(self.cache, src, dst)
        g0 = [j for j, p in enumerate(plans) if p[2] == 0]
        g1 = [j for j, p in enumerate(plans) if p[2] > 0]
        last_rows: List[Optional[np.ndarray]] = [None] * len(plans)
        for grp, ext in ((g0, False), (g1, True)):
            if not grp:
                continue
            Sg = _bucket_len(
                max(len(plans[j][0].tokens) - plans[j][2] for j in grp),
                self.scfg.max_len)
            toks = np.zeros((B, Sg), dtype=np.int32)
            lens = np.ones((B,), dtype=np.int32)
            starts = np.zeros((B,), dtype=np.int32)
            slots = np.full((B,), B, dtype=np.int32)    # B = dropped row
            for row, j in enumerate(grp):
                req, slot, start = plans[j]
                t = np.asarray(req.tokens[start:], dtype=np.int32)
                toks[row, :len(t)] = t
                lens[row] = len(t)
                starts[row] = start
                slots[row] = slot
            with trace.span("prefill", bucket=Sg, n=len(grp),
                            level=self.level, ext=ext):
                if ext:
                    # the arena gather wants the table row of each BATCH row
                    rtbl = self.table[np.minimum(slots, B - 1)]
                    logits, c1 = self.exec.prefill_ext(
                        self._params_now(),
                        {"tokens": toks, "lengths": lens, "starts": starts},
                        self.cache, rtbl, level=self.level, bucket=Sg)
                else:
                    logits, c1 = self.exec.prefill(
                        self._params_now(), {"tokens": toks, "lengths": lens},
                        level=self.level, bucket=Sg)
                self.cache = self.exec.scatter_paged(
                    self.cache, c1, slots, self.table, starts)
            gl = self._last_logits(logits)
            for row, j in enumerate(grp):
                last_rows[j] = gl[row]
        last = np.stack(last_rows)                     # (n_plans, V)
        reqs = [p[0] for p in plans]
        if self.faults is not None:
            for j in self.faults.prefill_rows_to_poison(
                    self.stats["admissions"], len(plans)):
                last[j] = np.nan
        self._poison_rid_rows(reqs, last)
        finite = np.isfinite(last).all(axis=-1)
        tok = last.argmax(-1).astype(np.int32)
        tok[~finite] = 0
        self._set_tokens(np.asarray([p[1] for p in plans], dtype=np.int32),
                         tok)
        bad: List[int] = []
        now = time.perf_counter()
        for j, (req, slot, start) in enumerate(plans):
            if finite[j]:
                req.out.append(int(tok[j]))
                self._emit_token(req, int(tok[j]))
                req.t_first = req.t_first or now
                self._metrics.observe_ttft(now - req.t_submit)
                self.slots[slot] = req
                self._progress += 1
                if self.prefix is not None:
                    self.prefix.register(np.asarray(req.tokens),
                                         self.table[slot], self.pool)
            else:
                bad.append(j)
        if bad:
            ambiguous = len(bad) == len(plans) and len(plans) > 1
            self._purge_slots([plans[j][1] for j in bad],
                              [plans[j][0] for j in bad])
            self._quarantine([plans[j][0] for j in bad], ambiguous)
        return len(plans)

    def _host_release(self, rows: List[int], reqs: List[Request],
                      contaminated: bool) -> List[int]:
        """Drop each request's block references and clear its table row.
        ``contaminated`` (poison purge): prefix-cache entries built on the
        request's own (fresh) blocks are evicted first, and every block
        whose refcount hits zero is returned for zeroing on the device,
        while shared prefix blocks another holder still references survive
        untouched. Clean retirement frees without zeroing (a freed block
        is unreachable: no table row points at it, and masked positions
        contribute exact zeros)."""
        zero: List[int] = []
        for slot, req in zip(rows, reqs):
            held, nshared = self._req_blocks.pop(req.rid, ([], 0))
            if contaminated and self.prefix is not None:
                fresh = held[nshared:]
                if fresh:
                    n = self.prefix.evict_blocks(fresh, self.pool)
                    if n:
                        self._metrics.bump("prefix_evictions", n)
            for b in held:
                if self.pool.decref(b) and contaminated:
                    zero.append(b)
            self.table[slot] = 0
        self._table_dev = None
        self._kv_gauges()
        return zero

    def _release_retired(self, rows: List[int],
                         reqs: List[Request]) -> None:
        """Return a retired request's blocks to the pool (no zeroing) and
        mark its slot row dead (pos = -1) so later decode steps neither
        write through the cleared table row nor emit junk."""
        self._host_release(rows, reqs, contaminated=False)
        B = self.scfg.batch
        pad = np.full((B,), B, dtype=np.int32)
        pad[:len(rows)] = rows
        blk = np.full((B * self.nb,), self.n_blocks, dtype=np.int32)
        self.cache = self.exec.purge_paged(self.cache, pad, blk)

    # ---- poison quarantine -----------------------------------------------
    def _purge_slots(self, rows: List[int],
                     reqs: Optional[List[Request]] = None) -> None:
        """Quarantine slot cleanup. Contiguous pool: zero the cache rows
        and next-token entries. Paged pool (``reqs`` required: the block
        bookkeeping is per request): release the requests' blocks, zero
        exactly the blocks whose refcount hit zero (a shared prefix block
        another request or the cache still holds is never zeroed), and
        mark the rows dead."""
        with trace.span("purge", rows=list(rows)):
            B = self.scfg.batch
            pad = np.full((B,), B, dtype=np.int32)
            pad[:len(rows)] = rows
            if self.paged:
                zero = self._host_release(rows, list(reqs or []),
                                          contaminated=True)
                blk = np.full((B * self.nb,), self.n_blocks,
                              dtype=np.int32)
                blk[:len(zero)] = zero
                self.cache = self.exec.purge_paged(self.cache, pad, blk)
            else:
                self.cache = self.exec.purge(self.cache, pad)
            self._set_tokens(pad, np.zeros((B,), dtype=np.int32))
        self._metrics.bump("slot_purges", len(rows))

    def _probe(self, reqs: List[Request]) -> np.ndarray:
        """Replay each suspect's (prompt + emitted tokens) in isolation, in
        one bucketed prefill (a recurrent stack: one exact-length prefill
        per suspect) that builds a fresh cache and never touches the pool,
        and report per-row finiteness. Reuses the admission prefill
        signatures."""
        self._metrics.bump("poison_probes")
        trace.instant("poison_probe", rids=[r.rid for r in reqs])
        seqs = []
        keep = self.scfg.max_len - 1
        for r in reqs:
            s = np.concatenate([np.asarray(r.tokens, dtype=np.int32),
                                np.asarray(r.out, dtype=np.int32)])
            seqs.append(s[-keep:])
        if not self.bucketed:
            verdict = np.zeros((len(reqs),), dtype=bool)
            for j, s in enumerate(seqs):
                logits, _ = self.exec.prefill(
                    self._params_now(), {"tokens": s[None, :]},
                    level=self.level)
                last = self._last_logits(logits)
                self._poison_rid_rows([reqs[j]], last)
                verdict[j] = bool(np.isfinite(last[0]).all())
            return verdict
        B = self.scfg.batch
        Sb = _bucket_len(max(len(s) for s in seqs), self.scfg.max_len)
        toks = np.zeros((B, Sb), dtype=np.int32)
        lens = np.ones((B,), dtype=np.int32)
        for j, s in enumerate(seqs):
            toks[j, :len(s)] = s
            lens[j] = len(s)
        logits, _ = self.exec.prefill(
            self._params_now(), {"tokens": toks, "lengths": lens},
            level=self.level, bucket=Sb)
        last = self._last_logits(logits)
        self._poison_rid_rows(reqs + [None] * (B - len(reqs)), last)
        return np.isfinite(last).all(axis=-1)[:len(reqs)]

    def _bisect_poison(self, reqs: List[Request]
                       ) -> tuple[List[Request], List[Request]]:
        """Attribute an ambiguous (every-live-row non-finite) poison event
        to the offending request(s) by bisection: replay suspects in
        isolation; a subset that still comes back all-bad splits in half
        until single offenders remain. Returns (offenders, collateral)."""
        verdict = self._probe(reqs)
        if verdict.all():
            return [], list(reqs)
        if not verdict.any() and len(reqs) > 1:
            mid = len(reqs) // 2
            o1, c1 = self._bisect_poison(reqs[:mid])
            o2, c2 = self._bisect_poison(reqs[mid:])
            return o1 + o2, c1 + c2
        offenders = [r for r, ok in zip(reqs, verdict) if not ok]
        collateral = [r for r, ok in zip(reqs, verdict) if ok]
        return offenders, collateral

    def _quarantine(self, reqs: List[Request], ambiguous: bool) -> None:
        """Evict poisoned requests: re-queue (front, retry budget) or fail
        typed. ``ambiguous=True`` means every live row was non-finite at
        once: bisect to the offender(s) first; proven-healthy collateral
        re-queues without consuming its retry budget, but only when an
        actual offender was identified (otherwise the event was a
        transient engine fault and everyone pays one retry, so a
        persistently faulty engine still terminates typed instead of
        looping forever)."""
        self._metrics.bump("poison_events")
        self.flight.note("poison", rids=[r.rid for r in reqs],
                         ambiguous=ambiguous, level=self.level,
                         step=self._step_idx)
        offenders, collateral = (self._bisect_poison(reqs) if ambiguous
                                 else (list(reqs), []))
        if not offenders:       # transient: no culprit to exonerate against
            charge, collateral = collateral, []
        else:
            charge = offenders
        for req in collateral:
            req.out = []
            req.t_first = 0.0
            self._emit_rewind(req)
            self.admission.requeue(req)
        for req in charge:
            req.retries += 1
            self._metrics.bump("poison_retries")
            if req.retries > self.acfg.max_retries:
                req.status = adm.FAILED_POISON
                req.error = (f"non-finite logits after {req.retries} "
                             f"attempts (retry budget "
                             f"{self.acfg.max_retries})")
                req.t_done = time.perf_counter()
                self.failed.append(req)
                self._metrics.bump("poison_failures")
                self._progress += 1          # terminal transition
                self.flight.note("fail", rid=req.rid, level=self.level,
                                 retries=req.retries, error=req.error)
                self.dump_flight("failed_poison",
                                 {"rid": req.rid, "error": req.error})
                self._emit_terminal(req)
            else:
                req.out = []
                req.t_first = 0.0
                self._emit_rewind(req)
                self.admission.requeue(req)

    # ---- step loop -------------------------------------------------------
    def step(self) -> int:
        """One engine iteration: beat liveness, shed overdue work, admit,
        one decode step for all live slots through the finite guard.
        Returns the number of healthy live slots stepped."""
        t0 = time.perf_counter()
        with trace.span("engine_step", step=self._step_idx):
            n = self._step_inner()
        wall_ms = (time.perf_counter() - t0) * 1e3
        self._metrics.observe_step_ms(wall_ms)
        self.flight.step_timing(self._step_idx - 1, wall_ms, n)
        return n

    def _step_inner(self) -> int:
        idx = self._step_idx
        self._step_idx += 1
        if self.heartbeat is not None:
            self.heartbeat.beat(idx)
        if self.faults is not None:
            if self.faults.wedged(idx):
                return 0                     # hung engine: no progress
            stall = self.faults.stall_for(idx)
            if stall:
                time.sleep(stall)
        self._adjust_rank_level()
        self._metrics.step_at_level(self.level)
        self._metrics.observe_queue_depth(len(self.queue))
        trace.counter("serve", queue_depth=len(self.queue),
                      rank_level=self.level)
        self._admit()
        live = [i for i, r in enumerate(self.slots) if r is not None]
        if not live:
            return 0
        with trace.span("decode_step", step=idx, live=len(live),
                        level=self.level):
            if self.paged:
                logits, self.cache = self.exec.decode_paged(
                    self._params_now(), self.cache, self.tokens,
                    self._table_device(), level=self.level)
            else:
                logits, self.cache = self.exec.decode(
                    self._params_now(), self.cache, self.tokens,
                    level=self.level)
        last = self._last_logits(logits)               # (B, V) host copy
        if self.faults is not None:
            for row in self.faults.decode_rows_to_poison(idx, live):
                last[row] = np.nan
        self._poison_rid_rows(self.slots, last)
        finite = np.isfinite(last).all(axis=-1)
        nxt = last.argmax(-1).astype(np.int32)
        good = [i for i in live if finite[i]]
        bad = [i for i in live if not finite[i]]
        nxt[~finite] = 0                     # poisoned tokens never emitted
        self.tokens = nxt[:, None].copy()
        retired_rows: List[int] = []
        retired_reqs: List[Request] = []
        for i in good:
            req = self.slots[i]
            req.out.append(int(nxt[i]))
            self._emit_token(req, int(nxt[i]))
            self._progress += 1
            if len(req.out) >= req.n_new:
                req.t_done = time.perf_counter()
                req.status = adm.DONE
                self._metrics.bump("completed")
                self.done.append(req)
                self.slots[i] = None
                if self.paged:
                    retired_rows.append(i)
                    retired_reqs.append(req)
                self._emit_terminal(req)
        if retired_rows:
            self._release_retired(retired_rows, retired_reqs)
        if bad:
            ambiguous = len(bad) == len(live) and len(live) > 1
            reqs = [self.slots[i] for i in bad]
            for i in bad:
                self.slots[i] = None
            self._purge_slots(bad, reqs)
            self._quarantine(reqs, ambiguous)
        return len(good)

    def run_until_drained(self, max_steps: int = 100000,
                          watchdog_s: Optional[float] = None
                          ) -> DrainResult:
        """Step until the queue and slots drain. Returns a ``DrainResult``
        (list of completed requests + ``status``): ``"drained"`` on a
        clean drain, ``"timeout"`` when ``max_steps`` is exhausted with
        work still pending, and ``"stalled"`` when ``watchdog_s`` elapses
        with no forward progress (no token emitted, nothing shed or
        failed): a wedged engine is reported, not spun on."""
        status = "drained"
        last_progress = time.perf_counter()
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                break
            before = (self._progress
                      + self._metrics.count("shed_deadline"))
            self.step()
            now = time.perf_counter()
            if (self._progress
                    + self._metrics.count("shed_deadline")) > before:
                last_progress = now
            elif (watchdog_s is not None
                    and now - last_progress > watchdog_s):
                status = "stalled"
                break
        else:
            status = "timeout"
        undrained = ([r for r in self.slots if r is not None]
                     + list(self.queue))
        if status == "timeout" and not undrained:
            status = "drained"     # last permitted step finished the work
        if status != "drained":
            self.dump_flight(status,
                             {"undrained_rids": [r.rid for r in undrained]})
        return DrainResult(self.done, status, undrained,
                           shed=list(self.admission.shed),
                           rejected=list(self.admission.rejected),
                           failed=list(self.failed))

    # ---- observability ---------------------------------------------------
    def metrics(self) -> Dict:
        """The structured serve-metrics snapshot (v2 schema + deprecated
        legacy aliases: queue depth, shed counts, retries, rank-bucket
        residency, TTFT/queue-wait percentiles, retrace counters)."""
        return self._metrics.snapshot(len(self.queue), self.level,
                                      engine_stats=self.stats)

    def dump_flight(self, reason: str,
                    extra: Optional[Dict] = None) -> Optional[str]:
        """Dump the flight-recorder ring with full engine context (armed
        ``FaultPlan`` incl. seed, queue/slot state, elastic rung, step
        index). Returns the artifact path, or ``None`` when no dump dir
        is configured. Called automatically on a typed poison failure and
        a non-``drained`` drain."""
        ctx: Dict = {
            "step": self._step_idx,
            "rank_level": self.level,
            "ladder_len": len(self.ladder),
            "queue_depth": len(self.queue),
            "queued_rids": [r.rid for r in self.queue],
            "slot_rids": [r.rid if r is not None else None
                          for r in self.slots],
            "failed_rids": [r.rid for r in self.failed],
            "fault_plan": (json.loads(self.faults.to_json())
                           if self.faults is not None else None),
        }
        if extra:
            ctx.update(extra)
        return self.flight.dump(reason, ctx)
