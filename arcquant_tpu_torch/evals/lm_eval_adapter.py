"""lm-eval-harness adapter (counterpart of
``arcquant_tpu/evals/lm_eval_adapter.py``): run any lm-eval task against
the quantized model.

The task suites in evals/tasks.py cover the repository's evaluate.sh
offline; this adapter gives the harness's generality when the `lm_eval`
package is installed. It is imported only inside ``make_lm``; the tests
drive the LM API through a stub harness.

Usage:
  lm = make_lm(cfg, qparams, calib, qcfg, tokenizer)
  import lm_eval
  results = lm_eval.simple_evaluate(model=lm, tasks=["hellaswag"])

or ``python -m arcquant_tpu_torch.evaluate --model <dir> --lm_eval
hellaswag``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig, QuantConfig
from . import tasks as T


class _Scorer:
    """Batched, length-bucketed scoring over the accuracy-path forward
    (evals/tasks.py's loglikelihood and greedy-match functions over
    ``quant_model_forward``, or the bf16 forward), in full batches of
    `batch_size` rows whose width is tasks.py's bucket: the compute core
    of the LM methods."""

    def __init__(self, cfg: ModelConfig, qparams, calib,
                 qcfg: Optional[QuantConfig], batch_size: int = 8,
                 max_len: int = 2048):
        self.cfg = cfg
        self.batch = batch_size
        self.max_len = max_len
        self.device = qparams["embed"].device
        self._ll = T.make_loglikelihood_fn(cfg, qparams, qcfg, calib)
        self._greedy = T.make_greedy_match_fn(cfg, qparams, qcfg, calib)
        self._next = make_next_token_fn(cfg, qparams, calib, qcfg)

    def _pad_batch(self, rows: Sequence[Tuple[List[int], int]]):
        """rows: (tokens, ctx_len) -> (tokens [B, bucket], ctx_lens [B],
        lens [B]) on the model's device, for one bucket call."""
        lens = [len(t) for t, _ in rows]
        toks = np.zeros((len(rows), T._bucket(max(lens))), np.int32)
        for i, (t, _) in enumerate(rows):
            toks[i, :len(t)] = t
        ctx = np.asarray([c for _, c in rows], np.int32)
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (toks, ctx, np.asarray(lens, np.int32)))

    def score(self, reqs: Sequence[Tuple[List[int], List[int]]]
              ) -> List[Tuple[float, bool]]:
        """reqs: (context tokens, continuation tokens) -> (summed
        logprob, greedy match) each, lm-eval's loglikelihood contract.
        Requests go in length order, full batches (padded with dummy
        rows), a sequence cut to its last max_len tokens."""
        out: List[Optional[Tuple[float, bool]]] = [None] * len(reqs)
        order = sorted(range(len(reqs)),
                       key=lambda i: len(reqs[i][0]) + len(reqs[i][1]))
        for s in range(0, len(order), self.batch):
            idx = order[s:s + self.batch]
            rows = []
            for i in idx:
                ctx, cont = reqs[i]
                full = (list(ctx) + list(cont))[-self.max_len:]
                rows.append((full, max(1, len(full) - len(cont))))
            while len(rows) < self.batch:
                rows.append(([0, 0], 1))
            toks, ctx_l, lens = self._pad_batch(rows)
            lls = self._ll(toks, ctx_l, lens).float().cpu().numpy()
            greedy = self._greedy(toks, ctx_l, lens).cpu().numpy()
            for j, i in enumerate(idx):
                out[i] = (float(lls[j]), bool(greedy[j]))
        return out  # type: ignore[return-value]

    def score_rolling(self, streams: Sequence[List[int]],
                      bos_id: int = 0) -> List[float]:
        """Full-sequence logprob (lm-eval's loglikelihood_rolling):
        windows of max_len scored with a 1-token conditioning prefix
        carried over."""
        out = []
        for toks in streams:
            total, start = 0.0, 0
            toks = list(toks)
            while start < len(toks):
                win = toks[max(0, start - 1):start + self.max_len - 1]
                ctx_len = 1    # one conditioning token a window
                if start == 0:
                    win = [bos_id] + win
                (ll, _), = self.score([(win[:ctx_len], win[ctx_len:])])
                total += ll
                start += len(win) - ctx_len
            out.append(total)
        return out


def make_lm(cfg: ModelConfig, qparams, calib, qcfg: Optional[QuantConfig],
            tokenizer, batch_size: int = 8, max_len: int = 2048):
    """An lm_eval.api.model.LM over the quantized model (qcfg None or
    BF16: the bf16 forward). Needs the `lm_eval` package (ImportError
    otherwise); `tokenizer` is HF-style (encode, decode, bos_token_id)."""
    from lm_eval.api.model import LM

    scorer = _Scorer(cfg, qparams, calib, qcfg, batch_size, max_len)

    class ARCQuantLM(LM):
        def __init__(self):
            super().__init__()
            self.tokenizer = tokenizer

        def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
            reqs = []
            for r in requests:
                ctx, cont = r.args
                ctx_t = (tokenizer.encode(ctx) if ctx
                         else [getattr(tokenizer, "bos_token_id", 0) or 0])
                cont_t = tokenizer.encode(ctx + cont)[len(ctx_t):]
                if not cont_t:          # the tokenizer merged the join
                    cont_t = tokenizer.encode(cont)
                reqs.append((ctx_t, cont_t))
            return scorer.score(reqs)

        def loglikelihood_rolling(self, requests) -> List[float]:
            streams = [tokenizer.encode(r.args[0]) for r in requests]
            bos = getattr(tokenizer, "bos_token_id", 0) or 0
            return scorer.score_rolling(streams, bos_id=bos)

        def generate_until(self, requests) -> List[str]:
            # greedy, one token a forward over the last max_len - 1
            # tokens (generation tasks are rare in the suite; the serving
            # engine would be faster)
            outs = []
            for r in requests:
                ctx, gen_kwargs = r.args
                until = gen_kwargs.get("until", [])
                max_new = gen_kwargs.get("max_gen_toks", 128)
                toks = tokenizer.encode(ctx)
                done = []
                for _ in range(max_new):
                    row = toks[-scorer.max_len + 1:]
                    t, _c, lens = scorer._pad_batch(
                        [(row, len(row))] * scorer.batch)
                    nxt = int(scorer._next(t, lens)[0])
                    toks.append(nxt)
                    done.append(nxt)
                    text = tokenizer.decode(done)
                    if any(u in text for u in until):
                        for u in until:
                            if u in text:
                                text = text.split(u)[0]
                        break
                else:
                    text = tokenizer.decode(done)
                outs.append(text)
            return outs

    return ARCQuantLM()


def make_next_token_fn(cfg: ModelConfig, qparams, calib,
                       qcfg: Optional[QuantConfig]):
    """next(toks [B, T], lens [B]) -> the argmax token id at each row's
    last position, [B] int64."""
    forward = T._forward_fn(cfg, qparams, qcfg, calib)

    @torch.inference_mode()
    def nxt(toks, lens):
        logits = forward(toks)
        last = (lens.long() - 1).clamp(min=0)
        return logits[torch.arange(toks.shape[0], device=toks.device),
                      last].float().argmax(dim=-1)

    return nxt
