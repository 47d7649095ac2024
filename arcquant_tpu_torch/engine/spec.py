"""Speculative decoding over the paged int4 engine (counterpart of
``arcquant_tpu/engine/spec.py``).

A verify round runs W tokens a row through one multi-token forward
(``InferenceEngine.verify_step``: the last committed token and W - 1
drafts), so the decode GEMMs run at M = B * W and read the packed
weights once for W tokens. Greedy acceptance commits the longest prefix
of drafts equal to the target's own argmax, plus the target's next
token, so the output is plain greedy decode's token for token. Rollback
is free: appends address absolute positions, so a rejected draft's K/V
is overwritten later and never attended (seq_lens masks every read).

  - NgramDrafter: prompt-lookup drafting on the host (the longest suffix
    n-gram that occurs earlier proposes what followed it); no weights.
  - EngineDrafter: a second, smaller InferenceEngine drafts greedily
    through its own verify_step (catch-up) and decode_scan.
  - sample_verify: the exact-distribution stochastic verify for a
    deterministic proposal (Leviathan et al. 2023), drawing from an
    explicit torch.Generator.
  - device_ngram_draft: the n-gram drafter as shifted-window compares
    over a [B, H] device history, with no host read.
  - SpeculativeEngine.generate: the host verify loop, greedy or sampled.
  - SpeculativeEngine.generate_ondevice: draft, verify, acceptance,
    commit and eos / max-token retirement as one round body over device
    buffers. On the card the round is captured once as a CUDA graph and
    replayed in chunks of rounds, with one read of any(active) a chunk;
    a round with every row inactive changes nothing but the sink page,
    so rounds past the last are harmless. cuda_graphs=False runs the
    same body in an eager while-any(active) loop, the graph's bitwise
    reference. Every call of an engine runs on one state, emptied in
    place (InferenceEngine.reset_state), so the graphs keyed by it are
    captured once.
  - accept: a verify round's acceptance read back to the host, shared
    by SpeculativeEngine.generate and the batcher's spec round.

Token identity needs per-row activation scales (the engine's default): a
token's quantization grid is then independent of what shares the
forward. On the card a verify's attention is the paged prefill kernel at
Tq = W and decode's the paged decode kernel, whose outputs differ by an
ulp on a few elements, so on chaotic random weights greedy spec tokens
can leave plain decode's after many steps.
"""

from __future__ import annotations

import functools
import weakref
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import sampling as smp
from .engine import InferenceEngine, _Graph

# Rounds generate_ondevice replays between two reads of any(active),
# after a first chunk of the fewest rounds the run can take.
SPEC_CHUNK = 4


class NgramDrafter:
    """Prompt-lookup drafting: the longest suffix n-gram (n <= max_ngram)
    of each row's context that occurs earlier proposes the k tokens that
    followed its most recent earlier occurrence (else the last token,
    repeated). Host-side and model-free."""

    def __init__(self, max_ngram: int = 4):
        self.max_ngram = max_ngram
        self.ctx: List[List[int]] = []

    def begin(self, prompts: Sequence[Sequence[int]], max_batch: int):
        self.ctx = [list(p) for p in prompts]
        self.ctx += [[] for _ in range(max_batch - len(self.ctx))]

    def draft(self, seq, k: int) -> List[int]:
        """k draft tokens continuing `seq` (also the ContinuousBatcher's
        spec-mode entry point)."""
        out = [int(seq[-1])] * k
        hit = self._match(np.asarray(seq, np.int64))
        if hit is not None:
            got = [int(t) for t in seq[hit:hit + k]]
            out[:len(got)] = got
        return out

    def propose(self, cur: np.ndarray, k: int,
                active: np.ndarray) -> np.ndarray:
        out = np.zeros((len(self.ctx), k), np.int32)
        for b, c in enumerate(self.ctx):
            if active[b]:
                out[b, :] = self.draft(c + [int(cur[b])], k)
        return out

    def _match(self, seq: np.ndarray) -> Optional[int]:
        """Index just past the most recent earlier occurrence of the
        longest matching suffix n-gram, or None."""
        n_seq = len(seq)
        for n in range(min(self.max_ngram, n_seq - 1), 0, -1):
            pat = seq[n_seq - n:]
            ok = np.ones(n_seq - n, bool)     # starts before the suffix
            for j in range(n):
                ok &= seq[j:n_seq - n + j] == pat[j]
            hits = np.flatnonzero(ok)
            if hits.size:
                return int(hits[-1]) + n
        return None

    def commit(self, committed: List[List[int]], accepted: np.ndarray,
               new_lens: np.ndarray, active: np.ndarray):
        for b, toks in enumerate(committed):
            self.ctx[b].extend(toks)


class EngineDrafter:
    """Drafting by a second InferenceEngine (fewer layers, say), greedy.

    At a round's start each row's draft cache holds the target's
    committed tokens, except possibly the last (when every draft was
    accepted, the last draft's K/V never entered the draft cache): that
    token is fed first through the draft's verify_step. Rollback after a
    partial acceptance resets the draft's seq_lens (absolute-position
    appends make stale K/V harmless)."""

    def __init__(self, engine: InferenceEngine):
        if engine.ecfg.dynamic_pages:
            raise ValueError("EngineDrafter needs a static page layout "
                             "(it manages no allocator)")
        self.eng = engine
        self.state = None
        self._catchup: Optional[np.ndarray] = None
        self._drafts: Optional[np.ndarray] = None

    def begin(self, prompts: Sequence[Sequence[int]], max_batch: int):
        e = self.eng.ecfg
        if max_batch > e.max_batch:
            raise ValueError(f"draft engine max_batch {e.max_batch} < "
                             f"{max_batch}")
        toks, lens, _ = self.eng._pad_prompts(list(prompts))
        # one state for every run: its graphs are captured once
        self.state = (self.eng.new_state() if self.state is None
                      else self.eng.reset_state(self.state))
        _, self.state = self.eng.prefill(self.state, toks, lens)
        self._catchup = np.full((e.max_batch,), -1, np.int32)

    def propose(self, cur: np.ndarray, k: int,
                active: np.ndarray) -> np.ndarray:
        eng, catch = self.eng, self._catchup
        # the catch-up token and the first draft in one ragged verify:
        # rows with a pending token feed [catchup, cur], the rest [cur, 0];
        # retired rows feed nothing
        col0 = np.where(catch >= 0, catch, cur)
        col1 = np.where(catch >= 0, cur, 0)
        valid = np.where(active, np.where(catch >= 0, 2, 1), 0)
        logits, self.state = eng.verify_step(
            self.state, np.stack([col0, col1], axis=1).astype(np.int32),
            valid.astype(np.int32))
        valid_t = torch.as_tensor(valid, device=eng.device).to(torch.int32)
        # the fed tokens are committed ones: count them in now
        self.state[2].add_(valid_t)
        last = (valid_t.long() - 1).clamp(min=0)
        d1 = logits[torch.arange(logits.shape[0], device=eng.device),
                    last].argmax(-1).to(torch.int32)
        drafts = d1[:, None]
        if k > 1:
            rest, self.state = eng.decode_scan(
                self.state, d1, torch.as_tensor(active), k - 1)
            drafts = torch.cat([drafts, rest], dim=1)
        self._drafts = drafts.cpu().numpy()
        return self._drafts

    def commit(self, committed: List[List[int]], accepted: np.ndarray,
               new_lens: np.ndarray, active: np.ndarray):
        k = self._drafts.shape[1]
        full = accepted >= k               # every draft accepted
        self._catchup = np.where(active & full, self._drafts[:, k - 1],
                                 -1).astype(np.int32)
        want = np.where(full, new_lens - 1, new_lens).astype(np.int32)
        dl = self.state[2]
        dev = self.eng.device
        dl.copy_(torch.where(torch.as_tensor(active, device=dev),
                             torch.as_tensor(want, device=dev), dl))


def sample_verify(logits: torch.Tensor, drafts: torch.Tensor,
                  generator: torch.Generator, params=None, temperature=1.0,
                  top_k: int = 0, top_p=1.0) -> tuple:
    """Stochastic speculative verify for a deterministic proposal (both
    drafters are deterministic given the context), Leviathan et al. 2023
    with a point-mass q: draft d_i is accepted with probability
    p_{i-1}(d_i) under the warped target distribution (the one plain
    sampled decode draws from, sampling.warp_logits); at the first
    rejection the token is drawn from p with the rejected draft masked
    out (the (p - q)+ residual for q = delta_d); when every draft
    survives, the bonus token is a plain draw. Every emitted token is
    then distributed exactly as plain sampled decode's.

    temperature / top_p may be per-row [B] tensors (per-request sampled
    spec batching). Rows with temperature 0 take the exact greedy
    comparator: argmax acceptance on the raw logits and the argmax
    token.

    logits [B, W, V] raw verify logits; drafts [B, W - 1]; draws from
    `generator` (B * (W - 1) uniforms, then B * V Gumbel noises). Returns
    (n_acc [B] i32, out [B, W] i32): out[:, :n_acc] are the accepted
    drafts, out[:, n_acc] the resampled or bonus token."""
    b, w, v = logits.shape
    k = w - 1
    if params is not None:
        temperature, top_k, top_p = (params.temperature, params.top_k,
                                     params.top_p)
    dev = logits.device

    def rows(x):          # a per-row value, repeated for the W positions
        return (torch.as_tensor(x, dtype=torch.float32, device=dev)
                .expand(b).repeat_interleave(w)
                if isinstance(x, torch.Tensor) else x)
    x = smp.warp_logits(logits.reshape(b * w, v), rows(temperature), top_k,
                        rows(top_p)).reshape(b, w, v)
    drafts = drafts.long()
    pd = torch.softmax(x[:, :k], dim=-1).gather(-1, drafts[..., None])[..., 0]
    u = torch.rand((b, k), generator=generator, dtype=torch.float32,
                   device=dev)
    g = logits.argmax(-1)                                     # [B, W]
    greedy = smp._per_row(temperature, b, dev) <= 0.0         # [B]
    acc = torch.where(greedy[:, None], drafts == g[:, :-1], u < pd)
    n_acc = acc.long().cumprod(dim=1).sum(dim=1)              # [B]
    # the final draw's logits at position n_acc; a rejection masks the
    # rejected draft out
    ar = torch.arange(b, device=dev)
    xl = x[ar, n_acc]
    rej = drafts[ar, n_acc.clamp(max=k - 1)]
    xl = xl.masked_fill((n_acc < k)[:, None] & (
        torch.arange(v, device=dev)[None] == rej[:, None]), float("-inf"))
    fin = (xl + smp.gumbel_noise((b, v), generator, dev)).argmax(-1)
    fin = torch.where(greedy, g[ar, n_acc], fin)
    out = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    out = out.scatter(1, n_acc[:, None], fin[:, None])
    return n_acc.to(torch.int32), out.to(torch.int32)


def accept(logits: torch.Tensor, toksw: np.ndarray, generator=None,
           sampling=None, temperature=None, top_k: int = 0,
           top_p=1.0) -> tuple:
    """The acceptance of one verify round, read back to the host: (n_acc
    [B] i32, g [B, W] i32) as numpy arrays, g[:, :n_acc] the accepted
    drafts and g[:, n_acc] the token that follows them.

    toksw [B, W] holds the carried token and the W - 1 drafts the verify
    ran. Greedy (no `sampling`, no `temperature`): n_acc is the longest
    prefix of drafts equal to the target's argmax g. Otherwise
    sample_verify on `generator` with `sampling` (a SamplingParams) or
    per-row `temperature` / `top_p` arrays ([B]; rows at 0 take the
    greedy comparator)."""
    if sampling is None and temperature is None:
        g = logits.argmax(-1).to(torch.int32).cpu().numpy()
        same = toksw[:, 1:] == g[:, :-1]
        return np.cumprod(same, axis=1).sum(axis=1).astype(np.int32), g
    dev = logits.device
    if temperature is not None:
        temperature = torch.as_tensor(temperature, device=dev)
        top_p = torch.as_tensor(top_p, device=dev)
    n_acc, g = sample_verify(logits, torch.as_tensor(toksw[:, 1:], device=dev),
                             generator, sampling, temperature=temperature,
                             top_k=top_k, top_p=top_p)
    return n_acc.cpu().numpy(), g.cpu().numpy()


def device_ngram_draft(hist: torch.Tensor, hist_len: torch.Tensor, k: int,
                       max_ngram: int = 4) -> torch.Tensor:
    """Prompt-lookup drafting on the device: for each row, the most recent
    earlier occurrence of the longest suffix n-gram of hist[:hist_len]
    proposes the k tokens that followed it (else the last token,
    repeated). Shifted-window compares over the history, unrolled over
    n; no host read.

    hist [B, H] i32 (prompt + generated tokens, right-padded), H >
    max_ngram; hist_len [B] tokens valid a row (>= 1). Returns [B, k]
    i32."""
    b, h = hist.shape
    dev = hist.device
    hl = hist_len.long()[:, None]                             # [B, 1]
    cur = hist.gather(1, (hl - 1).clamp(min=0))               # [B, 1]
    best_end = torch.full((b,), -1, dtype=torch.long, device=dev)
    found = torch.zeros((b,), dtype=torch.bool, device=dev)
    for n in range(max_ngram, 0, -1):                         # longest wins
        pat = hist.gather(1, (hl - n + torch.arange(n, device=dev)[None])
                          .clamp(0, h - 1))                   # [B, n]
        m = torch.ones((b, h - n + 1), dtype=torch.bool, device=dev)
        for j in range(n):
            m &= hist[:, j:h - n + 1 + j] == pat[:, j:j + 1]
        s = torch.arange(h - n + 1, device=dev)[None]
        # starts strictly before the suffix itself, in rows of > n tokens
        m &= (s < hl - n) & (hl >= n + 1)
        s_best = s.expand(b, -1).masked_fill(~m, -1).amax(dim=1)
        hit = s_best >= 0
        best_end = torch.where(hit & ~found, s_best + n, best_end)
        found |= hit
    gidx = best_end[:, None] + torch.arange(k, device=dev)[None]
    ok = found[:, None] & (gidx >= 0) & (gidx < hl)
    d = hist.gather(1, gidx.clamp(0, h - 1))
    return torch.where(ok, d, cur).to(torch.int32)


@dataclass
class _SpecIO:
    """The persistent buffers of generate_ondevice's round body."""
    hist: torch.Tensor          # [B, H] i32: prompt + emitted tokens
    hist_len: torch.Tensor      # [B] i32: valid tokens of hist
    plen: torch.Tensor          # [B] i32: prompt lengths
    act: torch.Tensor           # [B] bool: rows still generating
    max_new: torch.Tensor       # [1] i32: max new tokens a row
    eos: torch.Tensor           # [1] i32: the eos id, -1 for none
    stats: torch.Tensor         # [3] i64: rounds, proposed, accepted

    @classmethod
    def new(cls, b: int, h: int, device) -> "_SpecIO":
        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)
        return cls(z(b, h), z(b), z(b), z(b, dtype=torch.bool), z(1),
                   torch.full((1,), -1, dtype=torch.int32, device=device),
                   z(3, dtype=torch.int64))


def _round(eng: InferenceEngine, state, io: _SpecIO, gen, w: int,
           max_ngram: int, sampling) -> None:
    """One round of generate_ondevice on the buffers, in place, with no
    host read: drafts from the history, the verify forward (active rows
    append W tokens, retired ones none), greedy or sampled acceptance,
    the emitted tokens (accepted drafts and the bonus, cut at the first
    eos and at max_new) into the history, seq_lens advanced by the
    accepted drafts + 1, the stats, and the retirement of rows that met
    eos or max_new."""
    cache, pt, seq_lens = state
    hist, hl, act = io.hist, io.hist_len, io.act
    cur = hist.gather(1, (hl.long() - 1).clamp(min=0)[:, None])
    drafts = device_ngram_draft(hist, hl, w - 1, max_ngram)
    toksw = torch.cat([cur, drafts], dim=1)
    logits = eng._verify_forward(cache, pt, seq_lens, toksw,
                                 act.to(torch.int32) * w)
    if sampling is None:
        g = logits.argmax(-1).to(torch.int32)
        n_acc = (toksw[:, 1:] == g[:, :-1]).to(torch.int32).cumprod(
            dim=1).sum(dim=1).to(torch.int32)
    else:
        n_acc, g = sample_verify(logits, drafts, gen, sampling)
    jr = torch.arange(w, dtype=torch.int32, device=hist.device)[None]
    is_eos = (g == io.eos) & (jr <= n_acc[:, None])
    first_eos = jr.expand_as(g).masked_fill(~is_eos, w).amin(dim=1)
    emit = torch.minimum(torch.minimum(n_acc + 1, first_eos),
                         io.max_new - (hl - io.plen))
    emit = emit.clamp(min=0) * act
    off = (torch.arange(hist.shape[1], dtype=torch.int32,
                        device=hist.device)[None] - hl[:, None])
    put = (off >= 0) & (off < emit[:, None])
    hist.copy_(torch.where(put, g.gather(1, off.clamp(0, w - 1).long()),
                           hist))
    hl.add_(emit)
    seq_lens.add_((n_acc + 1) * act)
    io.stats.add_(torch.stack([act.any().long(),
                               act.long().sum() * (w - 1),
                               (n_acc.long() * act).sum()]))
    act &= (first_eos > n_acc) & (hl - io.plen < io.max_new)


class SpeculativeEngine:
    """Speculative decoding over an InferenceEngine: greedy by default,
    token-identical to InferenceEngine.generate, at least one committed
    token a row per verify round.

    window = tokens per verify step (1 carried token + window - 1
    drafts). After a generate, `stats` holds {rounds, proposed,
    accepted} and `state` the state it decoded on (every call reuses
    it)."""

    def __init__(self, engine: InferenceEngine, drafter, window: int = 4):
        if window < 2:
            raise ValueError("window must be >= 2 (1 carried token + >= 1 "
                             "draft)")
        self.eng = engine
        self.drafter = drafter
        self.window = window
        self.stats = {"rounds": 0, "proposed": 0, "accepted": 0}
        self.state = None

    def _prefill(self, prompts, max_new_tokens: int):
        """Pad, check the capacity (a verify appends up to window - 1
        tokens past the committed length), map pages with that margin
        and prefill. Every call runs on one state, emptied in place, so
        the verify and round graphs (keyed by the state's tensors) are
        captured once an engine and window. Returns (toks, lens, b,
        logits, state)."""
        eng, e, w = self.eng, self.eng.ecfg, self.window
        toks, lens, b = eng._pad_prompts(list(prompts))
        cap = e.pages_per_seq * e.page_size
        for i in range(b):
            if int(lens[i]) + max_new_tokens + w > cap:
                raise ValueError(
                    f"prompt {i}: {int(lens[i])} + {max_new_tokens} new + "
                    f"window {w} exceeds per-slot KV capacity {cap}")
        self.state = (eng.new_state() if self.state is None
                      else eng.reset_state(self.state))
        state = eng._alloc_prompt_pages(self.state, lens, b,
                                        max_new_tokens, margin=w)
        logits, state = eng.prefill(state, toks, lens)
        return toks, lens, b, logits, state

    @torch.no_grad()
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int, eos_id: Optional[int] = None,
                 sampling=None, seed: int = 0) -> List[List[int]]:
        """Speculative decode with the host verify loop. Greedy by default
        (token-identical to plain greedy generate); `sampling` (a
        SamplingParams) switches to stochastic speculative sampling with a
        generator seeded by `seed` (sample_verify): every emitted token
        is distributed as plain sampled decode's, the drafts only change
        how many tokens a round commits."""
        eng, e, w = self.eng, self.eng.ecfg, self.window
        stochastic = sampling is not None and not sampling.is_greedy
        _, lens, b, logits, state = self._prefill(prompts, max_new_tokens)
        self.drafter.begin(prompts, e.max_batch)
        gen = eng._generator(seed)
        cur = eng._sample(logits, sampling if stochastic else None,
                          gen).cpu().numpy().astype(np.int32)
        out: List[List[int]] = [[] for _ in range(b)]
        done = lens == 0
        # the prefill's token is the first emission, as in generate()
        for i in range(b):
            if not done[i]:
                tok = int(cur[i])
                if eos_id is not None and tok == eos_id:
                    done[i] = True
                else:
                    out[i].append(tok)
                    done[i] = len(out[i]) >= max_new_tokens
        self.stats = {"rounds": 0, "proposed": 0, "accepted": 0}
        k = w - 1
        while not done.all():
            active = ~done
            drafts = self.drafter.propose(cur, k, active)
            toksw = np.concatenate([cur[:, None], drafts],
                                   axis=1).astype(np.int32)
            logits, state = eng.verify_step(
                state, toksw, np.where(active, w, 0).astype(np.int32))
            n_all, g = accept(logits, toksw, gen,
                              sampling if stochastic else None)
            committed: List[List[int]] = []
            commit_n = np.zeros((e.max_batch,), np.int32)
            n_acc = np.zeros((e.max_batch,), np.int32)
            for i in range(e.max_batch):
                if done[i]:
                    committed.append([])
                    continue
                n = n_acc[i] = int(n_all[i])
                committed.append([int(x) for x in toksw[i, :n + 1]])
                commit_n[i] = n + 1
                self.stats["proposed"] += k
                self.stats["accepted"] += n
                # emit the n accepted drafts and the bonus token
                for j in range(n + 1):
                    tok = int(g[i, j])
                    if eos_id is not None and tok == eos_id:
                        done[i] = True
                        break
                    out[i].append(tok)
                    if len(out[i]) >= max_new_tokens:
                        done[i] = True
                        break
                cur[i] = g[i, n]
            self.stats["rounds"] += 1
            seq_lens = state[2]
            seq_lens.add_(torch.as_tensor(commit_n, device=eng.device))
            self.drafter.commit(committed, n_acc, seq_lens.cpu().numpy(),
                                active)
        return out

    # -- the loop on the device ----------------------------------------------

    def _round_graph(self, state, max_ngram: int, sampling) -> _Graph:
        """The round body of (state, window, max_ngram, sampling): on the
        card a CUDA graph, cached by the engine beside its decode step;
        with cuda_graphs=False an uncaptured body."""
        eng, e = self.eng, self.eng.ecfg
        b, h = e.max_batch, e.pages_per_seq * e.page_size
        body = functools.partial(_round, w=self.window, max_ngram=max_ngram,
                                 sampling=sampling)
        if not eng.cuda_graphs:
            return _Graph(_SpecIO.new(b, h, eng.device), body,
                          weakref.ref(eng), None if sampling is None
                          else torch.Generator(device=eng.device))
        return eng._graph(state, ("spec", self.window, max_ngram, sampling),
                          "spec round", lambda: _SpecIO.new(b, h, eng.device),
                          body, sampled=sampling is not None)

    @torch.no_grad()
    def generate_ondevice(self, prompts: Sequence[Sequence[int]],
                          max_new_tokens: int, eos_id: Optional[int] = None,
                          max_ngram: int = 4, sampling=None,
                          seed: int = 0) -> List[List[int]]:
        """Speculative decoding with the device n-gram drafter and no host
        read inside the token loop: the host prefills, fills the history,
        replays the round (module docstring) and reads the history back.
        Greedy by default (token-identical to plain greedy generate);
        `sampling` switches to sample_verify, whose generator is seeded
        from `seed` before the rounds. self.drafter is not consulted."""
        eng, w = self.eng, self.window
        if sampling is not None and sampling.is_greedy:
            sampling = None
        if getattr(eng, "mesh", None) is not None:
            raise ValueError(
                "generate_ondevice runs the base single-chip forward as one "
                "round body; sharded engines (TP, PP) use the host verify "
                "loop (SpeculativeEngine.generate)")
        toks, lens, b, logits, state = self._prefill(prompts,
                                                     max_new_tokens)
        cur = eng._sample(logits, sampling, eng._generator(seed))
        g = self._round_graph(state, max_ngram, sampling)
        io, dev = g.io, eng.device
        # the history: the prompt, then the prefill's token
        plen = torch.as_tensor(lens, device=dev).to(torch.int32)
        io.hist.zero_()
        io.hist[:, :toks.shape[1]].copy_(torch.as_tensor(toks, device=dev))
        io.hist.scatter_(1, plen.long()[:, None], cur[:, None])
        act = plen > 0
        if eos_id is not None:
            act &= cur != eos_id
        io.hist_len.copy_(plen + act.to(torch.int32))
        io.plen.copy_(plen)
        io.act.copy_(act & (max_new_tokens > 1))
        io.max_new.fill_(max_new_tokens)
        io.eos.fill_(-1 if eos_id is None else eos_id)
        io.stats.zero_()
        if g.gen is not None:
            g.gen.manual_seed(smp.mix_seed(seed, 1))
        if not eng.cuda_graphs:
            while bool(io.act.any()):
                g.replay(state)
        else:
            # no row can finish in fewer rounds (short of an eos)
            n = max(1, -(-(max_new_tokens - 1) // w))
            while True:
                for _ in range(n):
                    g.replay(state)
                if not bool(io.act.any()):
                    break
                n = SPEC_CHUNK
        st = io.stats.tolist()
        self.stats = {"rounds": st[0], "proposed": st[1], "accepted": st[2]}
        hist, hl = io.hist.cpu().numpy(), io.hist_len.cpu().numpy()
        return [hist[i, lens[i]:hl[i]].tolist() for i in range(b)]
