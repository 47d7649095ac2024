"""Continuous-batching scheduler over the InferenceEngine (counterpart of
``arcquant_tpu/engine/scheduler.py``).

A request queue, slot allocation over the fixed-size device batch,
prefill admission, batched decode stepping, and completion/retirement,
all host-side logic around the engine's steps.

  - The device batch has a fixed width (EngineConfig.max_batch); slots
    are activated and retired through the decode step's `active` mask.
  - New requests are admitted by a prefill of the joining slots only
    (padded to the slot batch width with len-0 rows); the paged cache
    lets them land in their own pages without touching running ones.
    Prefill lengths are bucketed to powers of two.
  - With EngineConfig.dynamic_pages, a host-side PageAllocator free-lists
    the pool: prompt pages are mapped at admission, decode growth maps
    one page at a time, retirement frees, and requests queue when the
    pool is exhausted (admission) or preempt the youngest running
    sequence (growth). The page table is host numpy ([B, pps] i32); on
    change it is copied into the engine state's preallocated device
    tensor, never re-created. An engine with page groups
    (``engine.page_groups()``: the data-parallel TP engine's pool a dp
    group) gets one allocator a group, a slot's pages coming from its
    group's pool (ids local to it).
  - Speculative decoding (spec_window >= 2): each step is one verify
    round (engine.verify_step) over the running slots, drafted on the
    host by the drafter (engine/spec.py's NgramDrafter by default) and
    accepted greedily or, for sampled requests, by spec.sample_verify;
    a slot commits 1..W tokens a step. Logit bias, min_new_tokens,
    repetition penalties and per-request seeds are refused there.
"""

from __future__ import annotations

import hashlib
import itertools
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from . import sampling as smp
from .engine import InferenceEngine
from .spec import NgramDrafter, accept


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 128
    eos_id: Optional[int] = None
    request_id: int = field(default_factory=itertools.count().__next__)
    output: List[int] = field(default_factory=list)
    done: bool = False
    error: Optional[str] = None
    # per-request sampling (engine/sampling.py): 0 = greedy; top_k is
    # batcher-level
    temperature: float = 0.0
    top_p: float = 1.0
    # stop token sequences: generation ends when the output ends with any
    # of them; the stop suffix itself is trimmed
    stop: Optional[List[List[int]]] = None
    # additive per-token logit bias {token_id: bias} applied on the device
    # before sampling; -100-ish bans a token (OpenAI semantics)
    logit_bias: Optional[dict] = None
    # eos is suppressed until this many tokens exist
    min_new_tokens: int = 0
    # OpenAI-style repetition controls, from the output so far:
    # logits[tok] -= presence + frequency * count(tok)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # per-request sampling seed: the row's generator derives from (seed,
    # tokens generated so far), so this request's sampled stream is
    # reproducible whatever shares the batch (None = the batcher's
    # shared generator)
    seed: Optional[int] = None
    # serving metrics (host clock, filled by the batcher): submission,
    # first token, completion; preemption count
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    preempts: int = 0
    # cooperative cancellation: set (e.g. on client disconnect) and the
    # batcher retires the request at its next step
    cancelled: bool = False

    def tokens_so_far(self) -> List[int]:
        """Prompt + everything generated; what a (re-)prefill replays.
        `.prompt` is never mutated."""
        return list(self.prompt) + list(self.output)


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class PageAllocator:
    """Refcounted free-list allocator over the KV page pool (page 0 is
    the sink).

    Prefix sharing: immutable full-page prompt prefixes register under a
    chain key (a digest of all tokens up to the page end: K/V at position
    i depends on the whole prefix); `lookup_shared` + `share` bump a
    page's refcount instead of copying it. Released pages whose refcount
    reaches 0 stay cached (content intact, reusable) and are evicted FIFO
    only under pool pressure."""

    def __init__(self, num_pages: int):
        self.capacity = num_pages - 1    # page 0 is the sink
        self.free: List[int] = list(range(num_pages - 1, 0, -1))
        self.owned: dict = {}            # slot -> [page ids]
        self.ref: dict = {}              # page -> refcount
        self.cached: dict = {}           # chain key -> page (FIFO)
        self.page_key: dict = {}         # page -> chain key

    def available(self) -> int:
        """Pages allocatable right now: free + evictable cached."""
        evictable = sum(1 for p in self.page_key
                        if self.ref.get(p, 0) == 0)
        return len(self.free) + evictable

    def _evict_one(self) -> Optional[int]:
        for key, page in list(self.cached.items()):
            if self.ref.get(page, 0) == 0:
                del self.cached[key]
                del self.page_key[page]
                self.ref.pop(page, None)
                return page
        return None

    def alloc(self, slot: int, n: int) -> Optional[List[int]]:
        """Map n more pages to `slot`; None (and no change) if the pool
        cannot satisfy the request after evicting unreferenced cached
        pages."""
        if n > self.available():
            return None
        got: List[int] = []
        while len(got) < n:
            got.append(self.free.pop() if self.free else self._evict_one())
        for p in got:
            self.ref[p] = 1
        self.owned.setdefault(slot, []).extend(got)
        return got

    def lookup_shared(self, key) -> Optional[int]:
        return self.cached.get(key)

    def share(self, slot: int, page: int) -> None:
        """Map an existing cached page into `slot` (refcount + 1)."""
        self.ref[page] = self.ref.get(page, 0) + 1
        self.owned.setdefault(slot, []).append(page)

    def register(self, key, page: int) -> None:
        """Publish an immutable full prompt page for future sharing."""
        if key not in self.cached and page not in self.page_key:
            self.cached[key] = page
            self.page_key[page] = key

    def release(self, slot: int) -> None:
        for p in reversed(self.owned.pop(slot, [])):
            rc = self.ref.get(p, 1) - 1
            if rc > 0:
                self.ref[p] = rc
            else:
                self.ref.pop(p, None)
                if p not in self.page_key:
                    self.free.append(p)
                # else: stays cached (evictable) for future sharing


class ContinuousBatcher:
    """Admits requests into engine slots and steps the batch.

    top_k is the static top-k of sampled requests; `seed` seeds the
    shared generator of sampled requests without their own seed.
    decode_burst > 1 decodes that many tokens per step through
    ``engine.decode_scan`` when the queue is empty and every running
    request is greedy and bias-free; rows retiring mid-burst drop their
    tail tokens (their tail K/V is overwritten later, appends address
    absolute positions).

    spec_window >= 2 decodes by speculative verify rounds (module
    docstring); `drafter` needs a draft(seq, k) -> k tokens method, and
    `spec_stats` counts {rounds, proposed, accepted}. It excludes
    decode_burst."""

    def __init__(self, engine: InferenceEngine, top_k: int = 0,
                 seed: int = 0, spec_window: int = 0, drafter=None,
                 decode_burst: int = 0):
        if spec_window:
            if spec_window < 2:
                raise ValueError("spec_window must be >= 2")
            if decode_burst:
                raise ValueError("decode_burst and spec_window are "
                                 "exclusive decode strategies")
            if drafter is None:
                drafter = NgramDrafter()
            self.spec_stats = {"rounds": 0, "proposed": 0, "accepted": 0}
        self.spec_window = spec_window
        self.drafter = drafter
        self.engine = engine
        self.state = engine.new_state()
        e = engine.ecfg
        b = e.max_batch
        self.slots: List[Optional[Request]] = [None] * b
        self.next_token = np.zeros((b,), np.int32)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.top_k = top_k
        self._gen = torch.Generator(device=engine.device)
        self._gen.manual_seed(seed)
        self._pen_counts: List[Optional[dict]] = [None] * b
        self.decode_burst = decode_burst
        # dynamic pages: one PageAllocator a page group of the engine
        # (engine.page_groups(): one pool on a single device, one a dp
        # group under data parallelism, page ids local to the group; a
        # slot's pages come from its group's pool)
        self.allocs: Optional[List[PageAllocator]] = None
        self._stamp = itertools.count()     # admission order
        self._admitted_at: dict = {}        # slot -> stamp
        if e.dynamic_pages:
            ngroups, pages_per_group, self._slots_per_group = \
                engine.page_groups()
            self.allocs = [PageAllocator(pages_per_group)
                           for _ in range(ngroups)]
            self._pt = np.zeros((b, e.pages_per_seq), np.int32)
            self._pt_dirty = False

    @property
    def alloc(self) -> Optional[PageAllocator]:
        """The allocator of a one-group engine; None in grouped mode and
        with static pages."""
        if self.allocs is not None and len(self.allocs) == 1:
            return self.allocs[0]
        return None

    def _galloc(self, slot: int) -> PageAllocator:
        return self.allocs[slot // self._slots_per_group]

    def _seq_lens(self) -> np.ndarray:
        return self.state[2].cpu().numpy()

    # -- admission ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request. Token ids outside the vocabulary raise
        ValueError (an out-of-range embedding index would fault the
        device)."""
        v = self.engine.cfg.vocab_size
        if any(not 0 <= int(t) < v for t in req.prompt):
            raise ValueError(f"prompt token ids must lie in [0, {v})")
        if self.spec_window and (req.logit_bias or req.min_new_tokens
                                 or req.presence_penalty
                                 or req.frequency_penalty
                                 or req.seed is not None):
            # sampled requests are verified by sample_verify; these would
            # need per-position logit edits inside the verify window
            raise ValueError(
                "logit_bias / min_new_tokens / repetition penalties / "
                "per-request seeds are not supported with speculative "
                "batching (spec_window=0 supports them)")
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _bias_entries(self):
        """Per-slot (token, bias) pairs: request logit_bias, the
        min_new_tokens eos suppression, and the repetition penalties."""
        entries = []
        for i, s in enumerate(self.slots):
            e = []
            if s is not None:
                if s.logit_bias:
                    e += [(int(t), float(v))
                          for t, v in s.logit_bias.items()]
                # a token sampled now is recorded on top of the current
                # output, so eos stays banned while len(output) < min
                if (s.eos_id is not None and s.min_new_tokens
                        and len(s.output) < s.min_new_tokens):
                    e.append((int(s.eos_id), -1e9))
                if s.presence_penalty or s.frequency_penalty:
                    counts = self._pen_counts[i] or {}
                    e += [(int(t), -(s.presence_penalty
                                     + s.frequency_penalty * c))
                          for t, c in counts.items()]
            entries.append(e)
        return entries

    def _sample_rows(self, logits: torch.Tensor) -> np.ndarray:
        """Per-request sampling over a [B, V] logits batch: each slot's
        temperature, top_p and logit bias ride as per-row data; batches
        with no sampling and no bias take the argmax."""
        temps = np.asarray([s.temperature if s else 0.0
                            for s in self.slots], np.float32)
        entries = self._bias_entries()
        if not temps.any() and not any(entries):
            return logits.argmax(-1).to(torch.int32).cpu().numpy()
        dev = logits.device
        lg = logits.float().clone()
        rows = [i for i, e in enumerate(entries) for _ in e]
        if rows:
            toks = [t for e in entries for t, _ in e]
            vals = [v for e in entries for _, v in e]
            lg.index_put_((torch.tensor(rows, device=dev),
                           torch.tensor(toks, device=dev)),
                          torch.tensor(vals, dtype=torch.float32,
                                       device=dev), accumulate=True)
        # per-row generators: seeded rows derive from (seed, step), the
        # rest draw from the batcher's shared stream
        gens = [smp.row_generator(s.seed, len(s.output), dev)
                if (s is not None and s.seed is not None) else self._gen
                for s in self.slots]
        tps = np.asarray([s.top_p if s else 1.0 for s in self.slots],
                         np.float32)
        out = smp.sample_with_keys(
            lg, gens, torch.from_numpy(temps).to(dev), self.top_k,
            torch.from_numpy(tps).to(dev) if (tps < 1.0).any() else 1.0)
        return out.cpu().numpy().astype(np.int32)

    def _map_pages(self, slot: int, pages: List[int]) -> None:
        """Record newly allocated pages in the host page table."""
        row = self._pt[slot]
        used = int(np.count_nonzero(row))
        row[used:used + len(pages)] = pages
        self._pt_dirty = True

    def _set_pages(self, slot: int, pages: List[int]) -> None:
        """Replace a slot's page row (admission with shared prefix)."""
        self._pt[slot] = 0
        self._pt[slot, :len(pages)] = pages
        self._pt_dirty = True

    @staticmethod
    def _chain_keys(tokens: List[int], ps: int) -> List[str]:
        """Prefix-chain keys, one per full page: key j digests all tokens
        up to the page end, so pages match only when the whole prefix
        does."""
        h = hashlib.sha1()
        keys = []
        for j in range(len(tokens) // ps):
            h.update(np.asarray(tokens[j * ps:(j + 1) * ps],
                                np.int64).tobytes())
            keys.append(h.hexdigest())
        return keys

    def _push_pt(self) -> None:
        """Copy the host page table into the state's device table."""
        if self.allocs is not None and self._pt_dirty:
            self.state[1].copy_(torch.from_numpy(self._pt))
            self._pt_dirty = False

    def _admit(self) -> None:
        """Move queued requests into free slots and prefill them."""
        free = self._free_slots()
        if not free or not self.queue:
            return
        # KV-capacity admission check: reject prompts that cannot fit;
        # max_seq_len - 1 leaves room for >= 1 decoded token
        cap = self.engine.ecfg.max_seq_len - 1
        ps = self.engine.ecfg.page_size
        joining: List[tuple] = []
        while free and self.queue:
            req = self.queue.pop(0)
            # a preempted request replays prompt + prior output
            nprefill = len(req.tokens_so_far())
            need = -(-(nprefill + 1) // ps)
            if nprefill > cap or (self.allocs is not None
                                  and need > self.allocs[0].capacity):
                req.done = True
                req.error = (f"prompt length {nprefill} exceeds "
                             f"KV capacity")
                self.finished.append(req)
                continue
            slot = free[0]
            start = 0
            if self.allocs is not None:
                # prompt pages + the first decode token's page, from the
                # slot's group's pool; a full pool tries the other free
                # slots (other groups) before giving up. With
                # prefix_sharing, reuse the group's cached prefix pages
                # (refcount++) and allocate only the suffix + growth pages
                keys = (self._chain_keys(req.tokens_so_far(), ps)
                        if self.engine.ecfg.prefix_sharing else [])
                placed = False
                for cand in free:
                    a = self._galloc(cand)
                    nshared = 0
                    for key in keys[:(nprefill - 1) // ps]:
                        pg = a.lookup_shared(key)
                        if pg is None:
                            break
                        a.share(cand, pg)    # protects from eviction
                        nshared += 1
                    if a.alloc(cand, need - nshared) is None:
                        a.release(cand)      # undo the shares
                        continue
                    slot, start, placed = cand, nshared * ps, True
                    self._set_pages(slot, a.owned[slot])
                    break
                if not placed:
                    # every group's pool exhausted: requeue, stop (FIFO)
                    self.queue.insert(0, req)
                    break
            free.remove(slot)
            self.slots[slot] = req
            self._admitted_at[slot] = next(self._stamp)
            if req.presence_penalty or req.frequency_penalty:
                c: dict = {}
                for tk in req.output:
                    c[tk] = c.get(tk, 0) + 1
                self._pen_counts[slot] = c
            else:
                self._pen_counts[slot] = None
            joining.append((slot, req, start))
        if not joining:
            return
        b = self.engine.ecfg.max_batch
        # rows carry only each request's suffix (prefix sharing skips the
        # shared pages' forward entirely); lens stay absolute
        tmax = _bucket(max(len(r.tokens_so_far()) - s
                           for _, r, s in joining))
        tmax = min(tmax, self.engine.ecfg.max_seq_len)
        toks = np.zeros((b, tmax), np.int64)
        lens = np.zeros((b,), np.int32)
        starts = np.zeros((b,), np.int32)
        for slot, req, start in joining:
            p = req.tokens_so_far()
            toks[slot, :len(p) - start] = p[start:]
            lens[slot] = len(p)
            starts[slot] = start
        # prefill only joining slots (len-0 rows are inert: their appends
        # are masked and their logits unused)
        self._push_pt()
        logits, self.state = self.engine.prefill(
            self.state, toks, lens,
            starts=starts if starts.any() else None)
        first = self._sample_rows(logits)
        now = time.perf_counter()
        for slot, req, start in joining:
            self.next_token[slot] = first[slot]
            if req.t_first is None:     # preserved across preemption
                req.t_first = now
            if self.engine.ecfg.prefix_sharing:
                # publish this request's fresh immutable full pages
                # (decode appends land at >= nprefill, never in them)
                p = req.tokens_so_far()
                keys = self._chain_keys(p, ps)
                a = self._galloc(slot)
                for j in range(start // ps, len(p) // ps):
                    a.register(keys[j], int(self._pt[slot, j]))

    # -- stepping -----------------------------------------------------------

    def _release_slot(self, slot: int) -> None:
        if self.allocs is not None:
            self._galloc(slot).release(slot)
            self._pt[slot] = 0
            self._pt_dirty = True
        self.slots[slot] = None
        self._admitted_at.pop(slot, None)
        self._pen_counts[slot] = None

    def _retire(self, slot: int) -> None:
        req = self.slots[slot]
        req.done = True
        req.t_done = time.perf_counter()
        self.finished.append(req)
        self._release_slot(slot)

    def _record_token(self, i: int, tok: int) -> bool:
        """Record one produced token for slot i (eos / stop-sequence /
        max_new_tokens bookkeeping). Returns True while the slot keeps
        running."""
        req = self.slots[i]
        if req.eos_id is not None and tok == req.eos_id:
            self._retire(i)
            return False
        req.output.append(tok)
        c = self._pen_counts[i]
        if c is not None:
            c[tok] = c.get(tok, 0) + 1
        if self._hit_stop(req) or len(req.output) >= req.max_new_tokens:
            self._retire(i)
            return False
        return True

    @staticmethod
    def _hit_stop(req: Request) -> bool:
        """True when output ends with one of the request's stop
        sequences; the stop suffix is trimmed from the output."""
        if not req.stop:
            return False
        out = req.output
        for s in req.stop:
            n = len(s)
            if n and len(out) >= n and out[-n:] == list(s):
                del out[len(out) - n:]
                return True
        return False

    def _preempt(self, slot: int) -> None:
        """Pool exhausted mid-decode: free this sequence's pages and
        requeue it (it re-prefills prompt + output later)."""
        req = self.slots[slot]
        req.preempts += 1
        self._release_slot(slot)
        self.queue.insert(0, req)

    def _youngest(self, group: int) -> int:
        """Running slot of page group `group` admitted most recently: the
        preemption victim (least re-prefill work wasted)."""
        pool = {s: t for s, t in self._admitted_at.items()
                if s // self._slots_per_group == group}
        return max(pool, key=pool.get)

    def _grow_pages(self, ahead: int = 1) -> None:
        """Dynamic mode: before a decode step, every active slot must have
        pages mapped for append positions seq_len .. seq_len + ahead - 1;
        allocate on demand, preempting the youngest running sequence on
        pool exhaustion."""
        if self.allocs is None:
            return
        ps = self.engine.ecfg.page_size
        pps = self.engine.ecfg.pages_per_seq
        lens_np = self._seq_lens()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            have = int(np.count_nonzero(self._pt[i]))
            need = min((int(lens_np[i]) + ahead - 1) // ps + 1, pps)
            while have < need and self.slots[i] is not None:
                pages = self._galloc(i).alloc(i, 1)
                if pages is not None:
                    self._map_pages(i, pages)
                    have += 1
                    continue
                victim = self._youngest(i // self._slots_per_group)
                self._preempt(victim)
                if victim == i:
                    break           # evicted the requester itself

    def step(self) -> List[Request]:
        """Admit + one decode step (or burst). Returns the requests
        finished in this step."""
        before = len(self.finished)
        # cooperative cancellation: drop queued, retire running
        for r in [r for r in self.queue if r.cancelled]:
            self.queue.remove(r)
            r.done = True
            r.error = r.error or "cancelled"
            self.finished.append(r)
        for i, s in enumerate(self.slots):
            if s is not None and s.cancelled:
                s.error = s.error or "cancelled"
                self._retire(i)
        self._admit()
        active_slots = [i for i, s in enumerate(self.slots)
                        if s is not None]
        if not active_slots:
            return self.finished[before:]
        # record the token produced by the previous step (or prefill)
        for i in active_slots:
            self._record_token(i, int(self.next_token[i]))
        # KV capacity guard: retire any sequence about to overflow its
        # page range (spec mode: a whole verify window's appends,
        # committed or not)
        w = self.spec_window or 1
        lens_np = self._seq_lens()
        for i in range(len(self.slots)):
            if (self.slots[i] is not None
                    and lens_np[i] >= self.engine.ecfg.max_seq_len - w):
                self._retire(i)
        bn = 0 if self.spec_window else self._burst_size()
        self._grow_pages(ahead=max(w, bn))
        if bn and self.queue:
            # growth preempted someone: admission first, burst later
            bn = 0
        active = np.asarray([s is not None for s in self.slots])
        if active.any():
            self._push_pt()
            if self.spec_window:
                self._spec_round(active)
            elif bn:
                toks, self.state = self.engine.decode_scan(
                    self.state, torch.from_numpy(self.next_token),
                    torch.from_numpy(active), bn)
                toks = toks.cpu().numpy()
                alive = active.copy()
                # replay the per-step bookkeeping for the first bn - 1
                # tokens; the last stays pending (recorded at the next
                # step's start, exactly like per-step decode)
                for j in range(bn - 1):
                    for i in range(len(self.slots)):
                        if alive[i] and self.slots[i] is not None:
                            if not self._record_token(i, int(toks[i, j])):
                                alive[i] = False
                self.next_token = np.where(
                    alive, toks[:, bn - 1], self.next_token).astype(np.int32)
            else:
                logits, self.state = self.engine.decode_step(
                    self.state, torch.from_numpy(self.next_token),
                    torch.from_numpy(active))
                nxt = self._sample_rows(logits)
                self.next_token = np.where(active, nxt,
                                           self.next_token).astype(np.int32)
        return self.finished[before:]

    def _burst_size(self) -> int:
        """Burst length for this step, or 0 to decode per step: only with
        an empty queue, all-greedy bias-free requests, KV headroom for
        the whole burst on every running row, and (dynamic pages) enough
        allocatable pages that provisioning the burst preempts no one."""
        n = self.decode_burst
        if not n or self.queue:
            return 0
        lens_np = None
        ps = self.engine.ecfg.page_size
        extra: dict = {}        # page group -> pages the burst maps
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            if (s.temperature > 0 or s.logit_bias or s.min_new_tokens
                    or s.presence_penalty or s.frequency_penalty):
                return 0
            if lens_np is None:
                lens_np = self._seq_lens()
            if lens_np[i] + n + 1 > self.engine.ecfg.max_seq_len:
                return 0
            if self.allocs is not None:
                have = int(np.count_nonzero(self._pt[i]))
                need = (int(lens_np[i]) + n - 1) // ps + 1 - have
                if need > 0:
                    g = i // self._slots_per_group
                    extra[g] = extra.get(g, 0) + need
        if any(e > self.allocs[g].available() for g, e in extra.items()):
            return 0
        return n if lens_np is not None else 0

    def _spec_round(self, active: np.ndarray) -> None:
        """One speculative verify round: spec_window - 1 drafts a running
        slot from the drafter over its prompt + output, one multi-token
        verify, the accepted prefix committed. The accepted drafts enter
        each request's output now (with eos, stop and max-token
        bookkeeping); the bonus token becomes the pending next_token,
        recorded at the next step's start as in plain decode."""
        w, k = self.spec_window, self.spec_window - 1
        eng = self.engine
        b = eng.ecfg.max_batch
        drafts = np.zeros((b, k), np.int32)
        for i, req in enumerate(self.slots):
            if req is not None:
                # step() recorded the pending token already, so the
                # request's tokens end with next_token[i]
                drafts[i] = self.drafter.draft(req.tokens_so_far(), k)
        toksw = np.concatenate([self.next_token[:, None], drafts],
                               axis=1).astype(np.int32)
        logits, self.state = eng.verify_step(
            self.state, toksw, np.where(active, w, 0).astype(np.int32))
        temps = np.asarray([s.temperature if s else 0.0
                            for s in self.slots], np.float32)
        # per-request stochastic verify when a row samples (its
        # temperature-0 rows take the greedy comparator exactly)
        n_all, g = accept(
            logits, toksw, self._gen, temperature=temps if temps.any()
            else None, top_k=self.top_k,
            top_p=np.asarray([s.top_p if s else 1.0 for s in self.slots],
                             np.float32))
        commit = np.zeros((b,), np.int32)
        for i in range(b):
            if self.slots[i] is None or not active[i]:
                continue
            n = int(n_all[i])
            commit[i] = n + 1
            self.spec_stats["proposed"] += k
            self.spec_stats["accepted"] += n
            # the accepted drafts are final; the bonus g[i, n] waits as
            # the pending token
            for j in range(n):
                if not self._record_token(i, int(g[i, j])):
                    break
            self.next_token[i] = g[i, n]
        self.spec_stats["rounds"] += 1
        self.state[2].add_(torch.from_numpy(commit).to(eng.device))

    def run(self) -> List[Request]:
        """Drain queue + slots to completion."""
        while self.queue or any(s is not None for s in self.slots):
            self.step()
        return self.finished
