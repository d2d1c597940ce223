"""Speculative continuous batching: draft lookahead inside the engine.

Counterpart of ``nos_tpu/serve/spec_engine.py``: every scheduling round
runs speculative rounds over the whole batch (the draft steps k times,
the target verifies the chain in one ``decode_chunk``, per-row
acceptance advances each slot at its own pace; ``models/speculative.py``
holds the round), with the base Engine's slots, admission and sync
horizon.

Differences from the base Engine, all forced by the round:
- Admission is ALWAYS chunked (physical == logical positions), and each
  admission also ingests the prompt into a per-slot DRAFT KV cache, so
  the draft cache holds every committed token but the last from the
  start.
- Greedy only: acceptance is defined against the target's argmax;
  ``temperature > 0`` is rejected at submit.
- A slot's frontier can overshoot its budget by up to k a round, so its
  capacity is prompt + budget + k + 1 (checked at submit); finished
  riders clamp at max_len - k - 1, as in ``speculative_generate``.

The accepted counts are data-dependent, so the host cannot mirror the
positions arithmetically: each horizon's one pull returns the device
positions with the committed tokens.

Under a ``mesh`` (as the reference passes it through to ``Engine``) the
target runs on the Engine's tp / ep path over the rank's shards and
head-sharded cache; the draft's params and cache are whole on every
rank. Every rank drafts, verifies and accepts the same tokens: the
target's logits are gathered whole before each argmax.
"""
from __future__ import annotations

import torch

from nos_tpu_torch.models.generate import init_kv_cache
from nos_tpu_torch.models.llama import LlamaConfig
from nos_tpu_torch.models.lora import n_adapters
from nos_tpu_torch.models.speculative import _spec_round
from nos_tpu_torch.serve.engine import Engine, GenRequest
from nos_tpu_torch.util import metrics


class SpecEngine(Engine):
    """Engine whose decode path is speculative rounds over a draft model.

    ``run`` / ``submit`` / ``step`` keep the base contracts; completions
    are the TARGET's greedy tokens (up to chunk-vs-step drift on near-tied
    argmaxes, the speculative contract). ``stats()`` reports rounds and
    mean accepted drafts per active row-round. ``mesh=``: ``params`` are
    the rank's target shards (``shard_for_serving``), ``draft_params``
    the whole draft."""

    def __init__(self, params, config: LlamaConfig, draft_params,
                 draft_config: LlamaConfig, k: int = 4, **kwargs) -> None:
        if kwargs.get("rolling"):
            raise ValueError(
                "rolling cache is not supported with speculation (the "
                "round's chunk verify assumes physical == logical)"
            )
        if kwargs.get("kv_quant"):
            raise ValueError(
                "int8 KV cache is not wired for speculation (acceptance "
                "compares target logits tick for tick; quantization noise "
                "would silently change what 'match' means)"
            )
        if n_adapters(params) or n_adapters(draft_params):
            raise ValueError(
                "multi-tenant LoRA is not supported with speculation (the "
                "round closes over the param tree at init, so per-admission "
                "adapter re-pointing cannot reach it)"
            )
        super().__init__(params, config, **kwargs)
        self.d_params = draft_params
        self.d_config = draft_config
        self.k = k
        # a round commits 1..k+1 tokens a row; the horizon chains the
        # guaranteed count, so the divisor is the full-acceptance size
        self._tokens_per_sync = k + 1
        # the deepest draft write (the d_k ingest at pos + k) lands at
        # max_len - 1: live rows by the submit check, riders by the clamp
        self._d_cache = init_kv_cache(draft_config, self.slots_n, self.max_len,
                                      device=self.device)
        self._round = _spec_round(params, draft_params, config, draft_config, k,
                                  t_mesh=self.mesh)
        self.rounds = 0
        self._accepted_total = 0
        self._active_row_rounds = 0

    # ---------------------------------------------------------- frontend

    def submit(self, request: GenRequest, submit_at: "float | None" = None) -> int:
        if request.temperature > 0:
            raise ValueError(
                "speculative acceptance is defined against the target's "
                "argmax; sampling requests need the base Engine"
            )
        request.id = next(self._ids)
        self._validate_submit(
            request, len(request.prompt) + request.max_new_tokens + self.k + 1
        )
        self._queue.append(request)
        self.telemetry.on_submit(request, self._bucket(len(request.prompt)),
                                 submit_at=submit_at)
        metrics.SERVE_QUEUE_DEPTH.set(len(self._queue))
        return request.id

    def stats(self) -> dict:
        return {
            "rounds": self.rounds,
            "mean_accepted": self._accepted_total / max(1, self._active_row_rounds),
        }

    # -------------------------------------------------------- admission

    def _admit(self, b: int, request: GenRequest) -> None:
        # chunked target admission (the prefix cache applies), then the
        # same prompt into the draft row through the shared piece loop
        self._admit_chunked(b, request)
        prompt = list(request.prompt)
        n = min(self.prefill_chunk, self._bucket(len(prompt)))
        row = init_kv_cache(self.d_config, 1, self.max_len + 1, device=self.device)
        with self.telemetry.prefill_span(request, len(prompt), "draft"):
            self._ingest_pieces(self.d_params, self.d_config, row, prompt, n)
        for layer, row_layer in zip(self._d_cache, row):
            for key in ("k", "v"):
                layer[key][b].copy_(row_layer[key][0, :self.max_len])

    # ------------------------------------------------------------- tick

    def step(self, chunks: "int | None" = 1) -> None:
        for b in range(self.slots_n):
            if self._slots[b] is None and self._queue:
                request = self._queue.pop(0)
                with self.telemetry.admit_span(request):
                    self._admit(b, request)
        # rounds sync every horizon anyway (the counts are data-dependent):
        # admission first tokens always resolve eagerly
        self._resolve_admissions()
        for b in range(self.slots_n):
            self._retire(b)
        if not any(s is not None for s in self._slots):
            return
        rounds = self._sync_horizon() if chunks is None else max(1, chunks)
        self.rounds += rounds
        live = [b for b in range(self.slots_n) if self._slots[b] is not None]
        dev = self.device
        with self.telemetry.decode_span(rounds, len(live)):
            pos = torch.tensor(self._pos, device=dev)
            last = torch.tensor(self._last, device=dev)
            row_valid = torch.tensor(
                [s is not None and not s.done for s in self._slots], device=dev
            )
            outs, counts = [], []
            for _ in range(rounds):
                # finished riders advance up to k+1 a round; the clamp keeps
                # their chunk writes in bounds
                pos = pos.clamp(max=self.max_len - self.k - 1)
                pos, last, _, out, count = self._round(
                    self._cache, self._d_cache, pos, last, row_valid
                )
                outs.append(out)
                counts.append(count)
            # ONE transfer for the horizon: positions, last tokens, every
            # round's committed tokens and counts
            pulled = torch.cat(
                [pos, last, torch.stack(outs).flatten(), torch.stack(counts).flatten()]
            ).cpu().numpy()
        slots = self.slots_n
        pos_np, last_np = pulled[:slots], pulled[slots:2 * slots]
        outs_np = pulled[2 * slots:2 * slots + rounds * slots * (self.k + 1)].reshape(
            rounds, slots, self.k + 1)
        counts_np = pulled[2 * slots + rounds * slots * (self.k + 1):].reshape(rounds, slots)
        # virtual-clock cost: one speculative round is the decode unit
        self.telemetry.on_decode_ticks(rounds)
        metrics.SERVE_TICKS.inc(rounds)
        metrics.SERVE_SLOT_TICKS_ACTIVE.inc(rounds * len(live))
        metrics.SERVE_QUEUE_DEPTH.set(len(self._queue))
        self._pos = pos_np.copy()
        self._rope = self._pos.copy()  # chunked path: logical == physical
        self._last = last_np.copy()
        row_rounds = accepted = 0
        for r in range(rounds):
            for b in live:
                slot = self._slots[b]
                if slot.done:
                    continue
                row_rounds += 1
                committed = int(counts_np[r, b])
                accepted += committed - 1
                for j in range(committed):
                    if slot.done:
                        break
                    self._emit(b, int(outs_np[r, b, j]))
        self._active_row_rounds += row_rounds
        self._accepted_total += accepted
        if row_rounds:
            metrics.SERVE_SPEC_ROUNDS.inc(row_rounds)
            metrics.SERVE_SPEC_DRAFT_TOKENS.inc(row_rounds * self.k)
            metrics.SERVE_SPEC_ACCEPTED_TOKENS.inc(accepted)
        for b in live:
            self._retire(b)
        for b in range(self.slots_n):
            if self._slots[b] is None:
                self._pos[b] = 0
                self._rope[b] = 0
