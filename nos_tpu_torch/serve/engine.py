"""Continuous-batching serving engine, in PyTorch.

Counterpart of ``nos_tpu/serve/engine.py``: requests with different
prompt lengths and budgets share one fixed-shape batched decode. A
finishing request frees its slot mid-flight and the next queued request
is admitted without draining the batch.

Mechanics (the reference's, with its jit/scan programs written out as
Python loops over device tensors):

- One KV cache of [slots, max_len, Hkv, hd] per layer, updated IN PLACE:
  each decode tick writes every row's K/V at its own depth, admission
  copies a prefilled row into its slot, a prefix-cache hit copies the
  stored prefix into the fresh row cache. Whatever outlives an update (a
  prefix-cache entry) is a clone, never a view of the cache.
- Admission: short prompts prefill one LEFT-padded row per power-of-two
  bucket; long ones (and every sliding-window config) ingest through
  fixed-size ``decode_chunk`` pieces, optionally resuming from a cached
  prompt prefix.
- ``ticks_per_sync`` decode ticks per chunk, several chunks per round
  (``_sync_horizon``), and ONE device→host copy per ``step()`` carrying
  every chunk's tokens (and any deferred admission first tokens).
- Idle and finished slots ride every tick; their writes stay inside the
  cache (decode_step masks out-of-range writes) and their tokens are
  trimmed on the host.
- Sampling: one ``torch.Generator`` per request, seeded from (engine
  seed, request id) only, so a sampled stream is reproducible per seed
  and independent of co-tenants (not bitwise equal to the reference's
  ``jax.random`` streams).
- ``kv_quant``: every cache (batch, padded prefill, chunked row) is int8
  with its scale buffers, which ride every splice, snapshot and restore.
- Multi-tenant LoRA: over ``stack_lora_adapters`` params each request
  names its adapter; decode runs the tree re-pointed at the slots' ids
  and admission at the one row's (``with_adapter_rows``: the row
  selector changes, no weight is copied).

- Tensor- and expert-parallel serving (``mesh``; ``serve/sharded.py``):
  the params are the rank's shards (``shard_for_serving``), the cache
  holds the rank's ``n_kv_heads/tp`` heads and is allocated in shards,
  never whole; prefill, ingest and decode run on the rank's ``('tp',
  'ep')`` plane with the logits gathered (a MoE layer on the rank's
  experts, their outputs gathered over ep), so every rank emits the
  same tokens. Every rank runs this same host loop on the same
  submissions, with still one host sync per ``step()``. Other mesh axes
  replicate. ``kv_quant`` with a mesh raises ``ValueError``, as in the
  reference; multi-LoRA under a mesh raises ``NotImplementedError``.
"""
from __future__ import annotations

import itertools
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from nos_tpu_torch.models.generate import (
    decode_chunk,
    decode_step,
    init_kv_cache,
    pick_tokens_per_row,
    prefill,
)
from nos_tpu_torch.models.llama import LlamaConfig, params_device
from nos_tpu_torch.models.lora import n_adapters, with_adapter_rows
from nos_tpu_torch.serve.telemetry import ServeClock, ServeTelemetry
from nos_tpu_torch.util import metrics

# Left-pad bucket: token id that can never appear in a real prompt.
PAD_ID = -1


@dataclass
class GenRequest:
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    # Greedy when temperature == 0; otherwise temperature sampling with
    # optional top-k / nucleus filtering, from the request's own stream.
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    # Streaming: on_token(request_id, token) for each emitted token, from
    # the host at sync points. A streaming slot bounds the sync horizon.
    on_token: Optional[Callable[[int, int], None]] = None
    # Multi-tenant LoRA (engine built over stack_lora_adapters): which
    # stacked adapter this request's rows apply; 0 = the bare base.
    adapter: int = 0
    id: int = -1


@dataclass
class _Slot:
    request: GenRequest
    out: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class Completion:
    id: int
    tokens: List[int]


class Engine:
    """Continuous-batching engine over a fixed slot count.

    ``submit`` enqueues; ``step`` admits + decodes one round; ``run``
    drains everything and returns completions keyed by request id.
    """

    def __init__(
        self,
        params,
        config: LlamaConfig,
        max_slots: int = 4,
        max_len: int = 512,
        ticks_per_sync: int = 8,
        prefill_chunk: int = 256,
        seed: int = 0,
        prefix_cache_entries: int = 0,
        mesh=None,
        rolling: bool = False,
        kv_quant: bool = False,
        model: str = "default",
        telemetry: Optional[ServeTelemetry] = None,
        clock: Optional[ServeClock] = None,
    ) -> None:
        if kv_quant and mesh is not None:
            raise ValueError(
                "kv_quant + mesh is not wired (the scale arrays need "
                "their own head-sharding rules); pick one"
            )
        if mesh is not None and n_adapters(params):
            raise NotImplementedError(
                "multi-LoRA serving under a mesh is not supported (the "
                "reference's shard_for_serving has no rule for adapter nodes): "
                "merge the adapters, or serve them on one device"
            )
        # tensor-parallel serving: the rank's tp line (None: one device,
        # or a mesh whose tp is 1, which replicates)
        self.mesh = None
        if mesh is not None:
            from nos_tpu_torch.models.llama import _check_mesh
            from nos_tpu_torch.serve.sharded import serving_mesh

            _check_mesh(mesh, config)
            self.mesh = serving_mesh(mesh)
        self.params = params
        self.config = config
        self.device = params_device(params)
        self.telemetry = telemetry or ServeTelemetry(model=model, clock=clock)
        # Rolling sliding-window cache: physical slot = logical position
        # mod C (C = max_len - 1; the last slot stays the ingest's pad
        # target), so prompt + budget are unbounded.
        self.rolling = rolling
        # int8 KV cache: half the cache bytes; lossy decode reads.
        self.kv_quant = kv_quant
        if rolling:
            if config.sliding_window is None:
                raise ValueError("rolling cache requires a sliding_window config")
            if prefix_cache_entries:
                raise ValueError(
                    "prefix cache assumes physical == logical positions; "
                    "disable it with rolling=True"
                )
            if max_len - 1 < config.sliding_window + 8:
                # 8 = the minimum ingest piece width (_bucket floor)
                raise ValueError(
                    f"rolling cache needs max_len - 1 >= sliding_window + 8 "
                    f"({max_len - 1} < {config.sliding_window + 8})"
                )
            # a chunk's writes must never evict keys its own queries need
            prefill_chunk = min(prefill_chunk, max_len - 1 - config.sliding_window)
        self.slots_n = max_slots
        self.max_len = max_len
        self.ticks_per_sync = max(1, ticks_per_sync)
        # Tokens a slot is guaranteed per decode chunk: what _sync_horizon
        # divides budgets by (SpecEngine: k + 1 per speculative round).
        self._tokens_per_sync = self.ticks_per_sync
        self.prefill_chunk = max(8, prefill_chunk)
        # LRU over completed chunk-boundary prompt prefixes (chunked path
        # only); 0 disables.
        self.prefix_cache_entries = prefix_cache_entries
        self._prefix_cache: "OrderedDict[tuple, list]" = OrderedDict()
        self._cache = init_kv_cache(config, max_slots, max_len, quant=kv_quant,
                                    device=self.device, mesh=self.mesh)
        # Host-side control state, copied to the device once per round.
        self._pos = np.zeros(max_slots, np.int64)  # next physical write slot
        self._rope = np.zeros(max_slots, np.int64)  # logical position (no pads)
        self._key_valid = np.zeros((max_slots, max_len), bool)
        self._last = np.zeros(max_slots, np.int64)
        self._temp = np.zeros(max_slots, np.float32)
        self._topk = np.zeros(max_slots, np.int64)
        self._topp = np.ones(max_slots, np.float32)
        self._seed = int(seed)
        self._row_gens: List[Optional[torch.Generator]] = [None] * max_slots
        # Multi-tenant LoRA: each slot's adapter id (0 without adapters).
        self._n_adapters = n_adapters(params)
        self._adapter_rows = np.zeros(max_slots, np.int64)
        self._slots: List[Optional[_Slot]] = [None] * max_slots
        self._queue: List[GenRequest] = []
        self._done: List[Completion] = []
        self._ids = itertools.count()
        # (slot, device-scalar token) pairs from this round's admissions,
        # resolved together with the round's decode tokens.
        self._pending_first: List[tuple] = []
        metrics.SERVE_SLOTS.set(max_slots)

    # ---------------------------------------------------------- frontend

    def _validate_submit(self, request: GenRequest, need: int) -> None:
        """Degenerate requests fail loudly here, never mid-batch. ``need``
        is the worst-case physical frontier the request can reach."""
        if not request.prompt:
            raise ValueError("prompt must contain at least one token")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if request.adapter and not (0 <= request.adapter < max(1, self._n_adapters)):
            raise ValueError(
                f"adapter {request.adapter} out of range: the tree stacks "
                f"{self._n_adapters} adapters (0 = base)"
            )
        if self.rolling:
            return
        if len(request.prompt) > self.max_len:
            raise ValueError(
                f"prompt length {len(request.prompt)} > engine max_len "
                f"{self.max_len}"
            )
        if need > self.max_len:
            raise ValueError(
                f"request needs {need} cache slots > engine max_len "
                f"{self.max_len}"
            )

    def submit(self, request: GenRequest, submit_at: Optional[float] = None) -> int:
        """Enqueue a request. ``submit_at`` back-dates the telemetry
        submit stamp (in the engine clock's timeline)."""
        request.id = next(self._ids)
        # A slot's physical frontier can reach its admission frontier +
        # ceil((max_new-1)/ticks)*ticks before it frees; the admission
        # frontier is the bucket on the padded path, the raw length on
        # the chunked one.
        t = self.ticks_per_sync
        chunks = -(-max(0, request.max_new_tokens - 1) // t)
        bucket = self._bucket(len(request.prompt))
        chunked = bucket > self.prefill_chunk or self.config.sliding_window is not None
        frontier = len(request.prompt) if chunked else bucket
        self._validate_submit(request, frontier + chunks * t)
        self._queue.append(request)
        self.telemetry.on_submit(request, bucket, submit_at=submit_at)
        metrics.SERVE_QUEUE_DEPTH.set(len(self._queue))
        return request.id

    @property
    def busy(self) -> bool:
        """Anything queued or occupying a slot (the drain condition)."""
        return bool(self._queue) or any(s is not None for s in self._slots)

    def _decode_params(self):
        """The params decode runs: with stacked LoRA adapters, re-pointed
        at the slots' adapter ids (weights shared, not copied)."""
        if not self._n_adapters:
            return self.params
        return with_adapter_rows(self.params, self._adapter_rows)

    def _admission_params(self, adapter: int):
        """Single-row variant for prefill and ingest (B = 1)."""
        if not self._n_adapters:
            return self.params
        return with_adapter_rows(self.params, [adapter])

    def run(self) -> Dict[int, List[int]]:
        """Drain queue + slots; returns {request id: generated tokens},
        chaining decode chunks between host syncs (see _sync_horizon)."""
        while self._queue or any(s is not None for s in self._slots):
            self.step(chunks=None)
        out = {c.id: c.tokens for c in self._done}
        self._done.clear()
        return out

    def _sync_horizon(self, pending: frozenset = frozenset()) -> int:
        """Decode chunks until the next host decision point: a slot that
        can free while requests wait, or the drain's end. ``pending``:
        slots whose admission first token rides this round's pull."""
        t = self._tokens_per_sync
        horizons = []
        for b, s in enumerate(self._slots):
            if s is None or s.done:
                continue
            spent = len(s.out) + (1 if b in pending else 0)
            rem = max(1, s.request.max_new_tokens - spent)
            budget = -(-rem // t)
            if self.rolling:
                # unbounded budgets: cap the dispatches queued per sync
                budget = min(budget, 16)
            if s.request.eos_id is not None or s.request.on_token is not None:
                # an EOS can land any tick, and streamed tokens reach the
                # host only at syncs: a few chunks per sync at most
                budget = min(budget, 1 if self._queue else 4)
            horizons.append(budget)
        if not horizons:
            return 1
        if self._queue:
            return min(horizons)
        if len(horizons) > 1:
            # retire shorter co-tenants at their own frontier; the longest
            # slot takes another round
            return sorted(horizons)[-2]
        return horizons[0]

    # ---------------------------------------------------------- scheduling

    def _bucket(self, n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return min(b, self.prefill_chunk if self.rolling else self.max_len)

    def _splice(self, row_cache, b: int) -> None:
        """Copy a single-row cache into batch slot ``b`` (in place); a
        row longer than max_len (the chunked path's sacrificial slot)
        contributes its first max_len positions."""
        for layer, row in zip(self._cache, row_cache):
            for key in layer:
                n = min(row[key].shape[1], self.max_len)
                layer[key][b, :n].copy_(row[key][0, :n])

    def _admit(self, b: int, request: GenRequest) -> None:
        bucket = self._bucket(len(request.prompt))
        if bucket > self.prefill_chunk or self.config.sliding_window is not None:
            # windowed configs always ingest in pieces: positions stay
            # physical == logical, which the window mask requires
            self._admit_chunked(b, request)
            return
        pad = bucket - len(request.prompt)
        padded = torch.tensor(
            [[PAD_ID] * pad + list(request.prompt)], dtype=torch.long,
            device=self.device,
        )
        with self.telemetry.prefill_span(request, bucket, "padded"):
            logits, row_cache = prefill(
                self._admission_params(request.adapter), padded, self.config,
                bucket, pad_id=PAD_ID, quant=self.kv_quant, mesh=self.mesh,
            )
            first_logits = logits[:, -1]
            first = first_logits.argmax(dim=-1)
        self._splice(row_cache, b)
        self._adapter_rows[b] = request.adapter
        self._slots[b] = _Slot(request=request)
        self._pos[b] = bucket
        self._rope[b] = len(request.prompt)
        self._key_valid[b, :pad] = False
        self._key_valid[b, pad:] = True
        self._set_sampling(b, request)
        self._pending_first.append(
            (b, self._first_token(b, request, argmax=first[0], raw=first_logits))
        )

    def _admit_chunked(self, b: int, request: GenRequest) -> None:
        """Long-prompt admission: ingest the prompt through fixed-size
        decode_chunk pieces into a fresh single-row cache (positions
        [0, L), no left pad; the final RIGHT-padded piece writes its pads
        to the row cache's sacrificial trailing slot), then copy the row
        into the batch cache."""
        prompt = list(request.prompt)
        length = len(prompt)
        n = min(self.prefill_chunk, self._bucket(length))
        # rolling rows match the batch layout exactly (modulus C =
        # max_len - 1, pad slot max_len - 1); the physical == logical
        # layout keeps its sacrificial slot OUTSIDE max_len instead
        row_cache = init_kv_cache(
            self.config, 1, self.max_len if self.rolling else self.max_len + 1,
            quant=self.kv_quant, device=self.device, mesh=self.mesh,
        )
        # Longest cached prefix at one of this request's chunk boundaries;
        # the final piece always recomputes (its logits seed generation).
        resume = 0
        if self.prefix_cache_entries > 0:
            boundary = ((length - 1) // n) * n
            while boundary > 0:
                key = (request.adapter, tuple(prompt[:boundary]))
                entry = self._prefix_cache.get(key)
                if entry is not None:
                    self._prefix_cache.move_to_end(key)
                    with self.telemetry.prefix_restore_span(request, boundary):
                        for layer, cached in zip(row_cache, entry):
                            for k in layer:
                                layer[k][:, :boundary].copy_(cached[k])
                    resume = boundary
                    metrics.SERVE_PREFIX_HITS.inc()
                    metrics.SERVE_PREFIX_TOKENS_REUSED.inc(boundary)
                    break
                boundary -= n
        with self.telemetry.prefill_span(request, length - resume, "chunked"):
            logits = self._ingest_pieces(
                self._admission_params(request.adapter), self.config,
                row_cache, prompt, n, resume, mesh=self.mesh,
            )
        if self.prefix_cache_entries > 0:
            store_at = ((length - 1) // n) * n
            if store_at > 0:
                key = (request.adapter, tuple(prompt[:store_at]))
                if key not in self._prefix_cache:
                    # a clone: the row cache is written in place later
                    self._prefix_cache[key] = [
                        {k: layer[k][:, :store_at].clone() for k in layer}
                        for layer in row_cache
                    ]
                    while len(self._prefix_cache) > self.prefix_cache_entries:
                        self._prefix_cache.popitem(last=False)
        last_idx = (length - 1) % n
        first = logits[0, last_idx].argmax()
        self._splice(row_cache, b)
        self._adapter_rows[b] = request.adapter
        self._slots[b] = _Slot(request=request)
        self._pos[b] = length
        self._rope[b] = length
        self._key_valid[b, :] = True
        self._set_sampling(b, request)
        self._pending_first.append(
            (b, self._first_token(b, request, argmax=first,
                                  raw=logits[0, last_idx][None]))
        )

    def _ingest_pieces(self, params, config, row_cache, prompt, n: int,
                       resume: int = 0, mesh=None):
        """THE prompt-chunking loop: n-token pieces from ``resume``, the
        final piece RIGHT-padded with its pad writes masked to the row
        cache's sacrificial trailing slot. Returns the last piece's
        logits [1, n, vocab]. Target and draft (SpecEngine) ingestion
        share it, so their piece math cannot diverge."""
        logits = None
        for start in range(resume, len(prompt), n):
            piece = prompt[start:start + n]
            real = len(piece)
            piece = piece + [0] * (n - real)
            mask = torch.tensor([[True] * real + [False] * (n - real)],
                                device=self.device)
            logits, _ = decode_chunk(
                params, row_cache,
                torch.tensor([start], dtype=torch.long, device=self.device),
                torch.tensor([piece], dtype=torch.long, device=self.device),
                config, write_mask=mask, rolling=self.rolling, mesh=mesh,
            )
        return logits

    def _set_sampling(self, b: int, request: GenRequest) -> None:
        self._temp[b] = request.temperature
        self._topk[b] = request.top_k
        self._topp[b] = request.top_p

    def _request_generator(self, request_id: int) -> torch.Generator:
        """The request's sampling stream, a function of (engine seed,
        request id) only."""
        seed = np.random.SeedSequence([self._seed, request_id]).generate_state(
            1, dtype=np.uint64
        )[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return gen

    def _first_token(self, b: int, request: GenRequest, argmax, raw):
        """First generated token from the admission logits as a DEVICE
        scalar (step() pulls every admission's together), and the slot's
        sampling stream."""
        gen = self._request_generator(request.id)
        self._row_gens[b] = gen
        if request.temperature <= 0:
            return argmax
        tok = pick_tokens_per_row(
            raw.float().reshape(1, -1),
            [request.temperature], [request.top_k], [request.top_p], [gen],
        )
        return tok[0]

    def _resolve_admissions(self) -> None:
        """ONE device→host pull for every admission this round: emit each
        pending first token and free any slot it already satisfies."""
        if not self._pending_first:
            return
        toks = torch.stack([t for _, t in self._pending_first]).cpu().tolist()
        for (b, _), tok in zip(self._pending_first, toks):
            self._last[b] = tok
            self._emit(b, tok)
        self._pending_first.clear()

    def _must_resolve_eagerly(self) -> bool:
        """A pending first token must reach the host BEFORE decoding only
        when it can change scheduling: a budget of 1 or an eos_id."""
        for b, _ in self._pending_first:
            req = self._slots[b].request
            if req.max_new_tokens == 1 or req.eos_id is not None:
                return True
        return False

    def _emit(self, b: int, token: int) -> None:
        """Append one token; marks (but does not free) a finished slot."""
        slot = self._slots[b]
        if not slot.out:
            self.telemetry.on_first_token(slot.request)
        slot.out.append(token)
        req = slot.request
        if req.on_token is not None:
            req.on_token(req.id, token)
        if len(slot.out) >= req.max_new_tokens or (
            req.eos_id is not None and token == req.eos_id
        ):
            slot.done = True

    # ------------------------------------------------------------- tick

    def _decode_chunk(self, params, pos, last, rope, key_valid, sampling=None):
        """``ticks_per_sync`` decode ticks for every slot → (tokens
        [ticks, B], pos, last, rope), all on the device."""
        toks = []
        for _ in range(self.ticks_per_sync):
            logits, _ = decode_step(
                params, self._cache, pos, last, self.config,
                rope_pos=rope, key_valid=key_valid, rolling=self.rolling,
                mesh=self.mesh,
            )
            if sampling is None:
                last = logits.argmax(dim=-1)
            else:
                last = pick_tokens_per_row(logits, *sampling)
            toks.append(last)
            pos = pos + 1
            rope = rope + 1
        return torch.stack(toks), pos, last, rope

    def step(self, chunks: "int | None" = 1) -> None:
        """One scheduling round: admit into free slots, then run
        ``chunks`` decode chunks back-to-back with ONE device→host copy at
        the end (None: the horizon from the slots' budgets). A slot whose
        request completes mid-round rides the remaining ticks; its
        surplus tokens are trimmed here."""
        for b in range(self.slots_n):
            if self._slots[b] is None and self._queue:
                request = self._queue.pop(0)
                with self.telemetry.admit_span(request):
                    self._admit(b, request)
        deferred: List[tuple] = []
        if self._pending_first and self._must_resolve_eagerly():
            self._resolve_admissions()
            for b in range(self.slots_n):
                # admission can satisfy a whole request: free before decoding
                self._retire(b)
        else:
            deferred = self._pending_first
            self._pending_first = []
        if not any(s is not None for s in self._slots):
            return
        pending_b = frozenset(b for b, _ in deferred)
        chunks = self._sync_horizon(pending_b) if chunks is None else max(1, chunks)
        active_slots = sum(1 for s in self._slots if s is not None)
        with self.telemetry.decode_span(chunks, active_slots):
            dev = self.device
            # torch.tensor copies: the host mirrors change under the round
            pos = torch.tensor(self._pos, device=dev)
            last = torch.tensor(self._last, device=dev)
            rope = torch.tensor(self._rope, device=dev)
            key_valid = torch.tensor(self._key_valid, device=dev)
            for b, tok in deferred:
                last[b] = tok
            admit_last = last
            sampling = None
            if (self._temp > 0).any():
                sampling = (
                    torch.tensor(self._temp, device=dev),
                    torch.tensor(self._topk, device=dev),
                    torch.tensor(self._topp, device=dev),
                    [g if self._temp[b] > 0 else None
                     for b, g in enumerate(self._row_gens)],
                )
            tok_chunks = []
            params = self._decode_params()
            for _ in range(chunks):
                toks, pos, last, rope = self._decode_chunk(
                    params, pos, last, rope, key_valid, sampling
                )
                tok_chunks.append(toks)
            # ONE transfer for the whole round
            head = [admit_last[None]] if deferred else []
            pulled = torch.cat(head + tok_chunks).cpu().numpy()
        first_row = pulled[0] if deferred else None
        tokens = pulled[1:] if deferred else pulled  # [chunks*ticks, B]
        ticks = tokens.shape[0]
        # clock cost BEFORE any emit: deferred first tokens pay this pull
        self.telemetry.on_decode_ticks(ticks)
        for b, _ in deferred:
            self._emit(b, int(first_row[b]))
        metrics.SERVE_TICKS.inc(ticks)
        metrics.SERVE_SLOT_TICKS_ACTIVE.inc(ticks * active_slots)
        metrics.SERVE_QUEUE_DEPTH.set(len(self._queue))
        # host state mirrors the device: every row advanced `ticks`
        self._pos += ticks
        self._rope += ticks
        self._last = tokens[-1].astype(np.int64).copy()
        for b in range(self.slots_n):
            if self._slots[b] is None:
                continue
            for j in range(ticks):
                if self._slots[b].done:
                    break
                self._emit(b, int(tokens[j, b]))
            self._retire(b)
        # idle rows still ride every chunk; pin them at 0
        for b in range(self.slots_n):
            if self._slots[b] is None:
                self._pos[b] = 0
                self._rope[b] = 0

    def _retire(self, b: int) -> None:
        slot = self._slots[b]
        if slot is not None and slot.done:
            self._done.append(Completion(id=slot.request.id, tokens=slot.out))
            self.telemetry.on_retire(slot.request, len(slot.out))
            metrics.SERVE_REQUESTS.inc()
            metrics.SERVE_TOKENS.inc(len(slot.out))
            self._slots[b] = None
            self._temp[b] = 0.0
            self._topk[b] = 0
            self._topp[b] = 1.0
            self._row_gens[b] = None
            # rewind and invalidate the retired row
            self._pos[b] = 0
            self._rope[b] = 0
            self._key_valid[b, :] = False
            self._adapter_rows[b] = 0
