"""Speculative decoding: draft-model lookahead with the target's outputs.

Counterpart of ``nos_tpu/models/speculative.py``. A small draft model
proposes ``k`` tokens one step at a time, and the target verifies all of
them in ONE multi-token ``decode_chunk``. Greedy acceptance commits only
tokens equal to the target's own argmax (the first mismatch is replaced
by the target's token, the "bonus"), so the output is the target's
greedy sequence up to one numeric caveat: the chunked verify sums in
another order than stepwise decode, and an argmax whose top-2 gap is
below that drift can flip. The CPU tests pin token identity with the
reference on f32 tiny configs.

One round:
  1. the draft runs k steps from the last committed token,
  2. the target verifies [last, d_1..d_k] in one chunk,
  3. acceptance = the longest matching prefix; positions advance per row,
  4. one more draft step ingests d_k's K/V, so the draft cache holds
     every committed token but the last even after full acceptance.
K/V past a row's frontier is never attended (the frontier only unmasks
written history, and rewinds overwrite before they re-expose it), so a
rejection's rollback is a position decrement; the caches are written in
place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from nos_tpu_torch.models.generate import decode_chunk, decode_step, prefill
from nos_tpu_torch.models.llama import LlamaConfig, params_device

Params = Dict[str, object]


def _spec_round(t_params, d_params, t_config: LlamaConfig, d_config: LlamaConfig,
                k: int, t_mesh=None):
    """The one-round function over fixed params and configs:
    ``round_fn(t_cache, d_cache, pos [B], last [B], row_valid=None)`` →
    (new pos, bonus, drafts [B, k], committed tokens [B, k+1] valid
    through ``count``, count [B]), all on the device; both caches are
    written in place. ``t_mesh``: the target's serving mesh (its params
    and cache the rank's shards); the draft runs whole."""

    def round_fn(t_cache, d_cache, pos, last, row_valid=None):
        # 1. draft k tokens (writes K/V for [last, d_1..d_{k-1}])
        p, tok, drafts = pos, last, []
        for _ in range(k):
            logits, _ = decode_step(d_params, d_cache, p, tok, d_config,
                                    row_valid=row_valid)
            tok = logits.argmax(dim=-1)
            drafts.append(tok)
            p = p + 1
        drafts = torch.stack(drafts, dim=1)  # [B, k]

        # 2. the target verifies the whole chain in one chunk
        chunk = torch.cat([last[:, None], drafts], dim=1)  # [B, k+1]
        logits, _ = decode_chunk(t_params, t_cache, pos, chunk, t_config,
                                 row_valid=row_valid, mesh=t_mesh)
        targets = logits.argmax(dim=-1)  # [B, k+1]

        # 3. longest matching prefix: accept while d_{i+1} == t_i
        match = drafts == targets[:, :k]
        accepted = match.long().cumprod(dim=1).sum(dim=1)  # [B]: k if all matched
        idx = torch.arange(k + 1, device=last.device)[None, :]
        bonus = torch.gather(targets, 1, accepted[:, None])[:, 0]
        drafts_pad = F.pad(drafts, (0, 1))
        out = torch.where(
            idx < accepted[:, None], drafts_pad,
            torch.where(idx == accepted[:, None], bonus[:, None],
                        torch.zeros_like(drafts_pad)),
        )
        count = accepted + 1

        # 4. ingest d_k's K/V so full acceptance leaves no draft-cache hole
        decode_step(d_params, d_cache, pos + k, drafts[:, -1], d_config,
                    row_valid=row_valid)
        return pos + count, bonus, drafts, out, count

    return round_fn


def speculative_generate(
    target_params: Params,
    draft_params: Params,
    prompt: torch.Tensor,
    target_config: LlamaConfig,
    draft_config: LlamaConfig,
    max_new_tokens: int,
    k: int = 4,
    eos_id: Optional[int] = None,
) -> Tuple[torch.Tensor, dict]:
    """prompt [B, S] → (tokens [B, max_new_tokens], stats).

    Greedy speculative decoding; the output matches ``generate(
    target_params, ...)`` up to the chunk-vs-step drift above. ``stats``:
    rounds, and the mean accepted drafts per active row-round (finished
    rows count in neither). Finished rows keep riding the batch, out of
    the MoE expert-capacity race (``row_valid``), and their surplus is
    trimmed on the host; with ``eos_id`` a row is padded with
    it after its first EOS. One device→host pull per round."""
    dev = params_device(target_params)
    prompt = torch.as_tensor(prompt, device=dev)
    b, s = prompt.shape
    max_len = s + max_new_tokens + k + 2  # chunk overshoot + draft ingest margin
    t_logits, t_cache = prefill(target_params, prompt, target_config, max_len)
    _, d_cache = prefill(draft_params, prompt, draft_config, max_len)
    first = t_logits[:, -1].argmax(dim=-1)
    round_fn = _spec_round(target_params, draft_params, target_config,
                           draft_config, k)

    pos = torch.full((b,), s, dtype=torch.long, device=dev)
    last = first
    rows: List[List[int]] = [[tok] for tok in first.tolist()]
    done = [eos_id is not None and r[0] == eos_id for r in rows]
    rounds = accepted_total = active_row_rounds = 0
    while not all(len(r) >= max_new_tokens or d for r, d in zip(rows, done)):
        active = [not d and len(r) < max_new_tokens for r, d in zip(rows, done)]
        # finished rows advance up to k+1 a round: the clamp keeps their
        # chunk writes inside max_len (live rows never reach it)
        pos = pos.clamp(max=max_len - k - 1)
        pos, last, _, out, count = round_fn(
            t_cache, d_cache, pos, last, torch.tensor(active, device=dev)
        )
        rounds += 1
        pulled = torch.cat([out, count[:, None]], dim=1).cpu().tolist()
        for i in range(b):
            if not active[i]:
                continue  # a rider's acceptance must not pollute the stats
            n = pulled[i][-1]
            active_row_rounds += 1
            accepted_total += n - 1  # drafts only, not the bonus
            for tok in pulled[i][:n]:
                if len(rows[i]) >= max_new_tokens:
                    break
                rows[i].append(tok)
                if eos_id is not None and tok == eos_id:
                    done[i] = True
                    break
    for i in range(b):
        fill = eos_id if (eos_id is not None and done[i]) else 0
        rows[i] = (rows[i] + [fill] * max_new_tokens)[:max_new_tokens]
    stats = {
        "rounds": rounds,
        "mean_accepted": accepted_total / max(1, active_row_rounds),
    }
    return torch.tensor(rows, dtype=prompt.dtype, device=dev), stats
