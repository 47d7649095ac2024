"""Loglikelihood task suites (counterpart of
``arcquant_tpu/evals/tasks.py``): multiple-choice accuracy by the summed
token log-probabilities of each continuation given its context, with
optional n-shot context assembly (subject-matched dev shots and the
description header for MMLU, as lm-eval's fewshot_context), and greedy
exact match for lambada-style tasks.

Task data comes from HF ``datasets`` (imported only for a real task);
``synthetic:<n>`` and ``greedy:<n>`` make n deterministic token-level
items that exercise the whole scoring path (a pipeline check, not a
model metric).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig, QuantConfig
from ..models import llama, quantized


def _piqa(d):
    return (f"Question: {d['goal']}\nAnswer:",
            [" " + d["sol1"], " " + d["sol2"]], int(d["label"]))


def _arc(d):
    idx = d["choices"]["label"].index(d["answerKey"])
    return (f"Question: {d['question']}\nAnswer:",
            [" " + t for t in d["choices"]["text"]], idx)


def _boolq(d):
    return (f"{d['passage']}\nQuestion: {d['question']}?\nAnswer:",
            [" no", " yes"], int(d["answer"]))


def _hellaswag(d):
    return (d["ctx"], [" " + e for e in d["endings"]], int(d["label"]))


def _winogrande(d):
    """lm-eval's partial scoring: the text after the blank is the one
    continuation, scored under each option's substituted context."""
    pron = d["sentence"].index("_")
    pre, post = d["sentence"][:pron], d["sentence"][pron + 1:]
    return ([pre + d["option1"], pre + d["option2"]], [post, post],
            int(d["answer"]) - 1)


def _lambada(d):
    words = d["text"].rsplit(" ", 1)
    return (words[0], [" " + words[1]], 0)


# Scored by greedy exact match of the one continuation (argmax over the
# whole vocab at every target position), not multiple choice.
GREEDY_TASKS = frozenset({"lambada"})

_MMLU_LETTERS = ("A", "B", "C", "D")


def _mmlu(d):
    """lm-eval's hendrycksTest format: lettered choices, the answer
    letter as the continuation."""
    lines = [f"{d['question'].strip()}"]
    for letter, choice in zip(_MMLU_LETTERS, d["choices"]):
        lines.append(f"{letter}. {choice}")
    lines.append("Answer:")
    return ("\n".join(lines), [" " + s for s in _MMLU_LETTERS],
            int(d["answer"]), d.get("subject", ""))


# task -> (load_dataset args, eval split, doc formatter, few-shot split)
TASK_SPECS = {
    "piqa": (("piqa",), "validation", _piqa, "train"),
    "arc_easy": (("ai2_arc", "ARC-Easy"), "test", _arc, "train"),
    "arc_challenge": (("ai2_arc", "ARC-Challenge"), "test", _arc, "train"),
    "boolq": (("boolq",), "validation", _boolq, "train"),
    "hellaswag": (("hellaswag",), "validation", _hellaswag, "train"),
    "winogrande": (("winogrande", "winogrande_xl"), "validation",
                   _winogrande, "train"),
    "lambada": (("EleutherAI/lambada_openai",), "test", _lambada, None),
    "mmlu": (("cais/mmlu", "all"), "test", _mmlu, "dev"),
}

_MMLU_DESCRIPTION = ("The following are multiple choice questions "
                     "(with answers) about {subject}.\n\n")


def _norm_doc(doc):
    """A formatter's result as (ctx, choices, ans, subject)."""
    return (*doc, None) if len(doc) == 3 else doc


def _is_per_choice(ctx) -> bool:
    """True when the context is one string per choice (winogrande)."""
    return (isinstance(ctx, (list, tuple)) and len(ctx) > 0
            and isinstance(ctx[0], str))


def _synthetic_docs(task: str, vocab_size: int, seed: int):
    n = int(task.split(":")[1]) if ":" in task else 64
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n):
        ctx = rng.integers(1, vocab_size, size=24).tolist()
        choices = [rng.integers(1, vocab_size, size=6).tolist()
                   for _ in range(4)]
        docs.append((ctx, choices, int(rng.integers(0, 4)), None))
    return docs


def load_task_docs(task: str, limit: Optional[int] = None,
                   vocab_size: int = 32000, seed: int = 0,
                   split: Optional[str] = None):
    """[(context str or tokens, choices, answer index, subject or
    None)]: synthetic items for `synthetic:<n>` / `greedy:<n>`, else the
    task's eval split (or `split`) through HF `datasets`."""
    if task.startswith(("synthetic", "greedy")):
        return _synthetic_docs(task, vocab_size, seed)
    from datasets import load_dataset  # only for a real task
    args, eval_split, fn, _ = TASK_SPECS[task]
    ds = load_dataset(*args, split=split or eval_split)
    docs = [_norm_doc(fn(d)) for d in ds]
    return docs[:limit] if limit else docs


def _fewshot_prefix(shot_docs, subject, n: int, token_level: bool):
    """An n-shot prefix: each shot's context and its correct
    continuation, blank-line joined (concatenated for token-level
    docs), subject-matched where subjects exist."""
    pool = [d for d in shot_docs
            if subject is None or d[3] is None or d[3] == subject]
    shots = pool[:n]
    if token_level:
        out = []
        for ctx, choices, ans, _ in shots:
            out.extend(list(ctx))
            out.extend(list(choices[ans]))
        return out
    parts = [f"{ctx[ans] if _is_per_choice(ctx) else ctx}{choices[ans]}"
             for ctx, choices, ans, _ in shots]
    return "\n\n".join(parts) + ("\n\n" if parts else "")


def _bucket(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _forward_fn(cfg: ModelConfig, qparams, qcfg: Optional[QuantConfig],
                calib):
    if qcfg is None or qcfg.quant_type == "BF16":
        return lambda toks: llama.model_forward(cfg, qparams, toks)
    return lambda toks: quantized.quant_model_forward(cfg, qparams, calib,
                                                      qcfg, toks)


def _continuation_mask(tgt, ctx_lens, lens):
    """[B, T-1]: the target positions of each row's continuation."""
    pos = torch.arange(tgt.shape[1], device=tgt.device)[None, :]
    return (pos >= ctx_lens[:, None] - 1) & (pos < lens[:, None] - 1)


def make_loglikelihood_fn(cfg: ModelConfig, qparams,
                          qcfg: Optional[QuantConfig], calib):
    """score(tokens [B, T] padded, ctx_lens [B], lens [B]) -> f32 [B]:
    the summed log-probability of tokens[ctx_len:len] given the
    prefix."""
    forward = _forward_fn(cfg, qparams, qcfg, calib)

    @torch.inference_mode()
    def score(toks, ctx_lens, lens):
        logp = torch.log_softmax(forward(toks)[:, :-1].float(), dim=-1)
        tgt = toks[:, 1:].long()
        picked = torch.gather(logp, -1, tgt[..., None])[..., 0]
        mask = _continuation_mask(tgt, ctx_lens, lens)
        return (picked * mask).sum(dim=1)

    return score


def make_greedy_match_fn(cfg: ModelConfig, qparams,
                         qcfg: Optional[QuantConfig], calib):
    """match(tokens [B, T] padded, ctx_lens [B], lens [B]) -> bool [B]:
    whether the argmax over the whole vocab at every continuation
    position reproduces tokens[ctx_len:len] (lm-eval's lambada); a row
    without a continuation is not a match."""
    forward = _forward_fn(cfg, qparams, qcfg, calib)

    @torch.inference_mode()
    def match(toks, ctx_lens, lens):
        pred = forward(toks)[:, :-1].float().argmax(dim=-1)
        tgt = toks[:, 1:].long()
        mask = _continuation_mask(tgt, ctx_lens, lens)
        ok = torch.where(mask, pred == tgt, torch.ones_like(mask))
        return ok.all(dim=1) & (lens > ctx_lens)

    return match


def evaluate_tasks(cfg: ModelConfig, qparams, tasks: Sequence[str],
                   tok_fn: Optional[Callable] = None,
                   qcfg: Optional[QuantConfig] = None, calib=None,
                   limit: Optional[int] = 200, batch: int = 8,
                   seed: int = 0, num_fewshot: int = 0
                   ) -> Dict[str, float]:
    """Accuracy per task (num_fewshot 0: zero-shot). The forward runs on
    qparams' device in padded batches of `batch` rows, T a power of two
    from 32."""
    device = qparams["embed"].device
    ll = make_loglikelihood_fn(cfg, qparams, qcfg, calib)
    gm = None
    results = {}
    for task in tasks:
        task = task.strip()
        greedy = task.split(":")[0] in GREEDY_TASKS or task.startswith(
            "greedy")
        if greedy and gm is None:
            gm = make_greedy_match_fn(cfg, qparams, qcfg, calib)
        docs = load_task_docs(task, limit, cfg.vocab_size, seed)
        shot_docs = []
        if num_fewshot > 0:
            if task.startswith(("synthetic", "greedy")):
                shot_docs = _synthetic_docs(
                    f"synthetic:{4 * num_fewshot}", cfg.vocab_size,
                    seed + 1)
            else:
                fs_split = TASK_SPECS[task][3]
                if fs_split is None:
                    raise ValueError(f"task {task} has no few-shot "
                                     "source split")
                shot_docs = load_task_docs(task, None, cfg.vocab_size,
                                           seed, split=fs_split)
        # (doc, choice) items; a greedy task has one, the gold one
        items = []   # (doc_idx, choice_idx, tokens, ctx_len)
        for di, (ctx, choices, ans, subject) in enumerate(docs):
            per_choice = _is_per_choice(ctx)
            token_level = isinstance(ctx, (list, tuple)) and not per_choice
            if num_fewshot > 0:
                prefix = _fewshot_prefix(shot_docs, subject, num_fewshot,
                                         token_level)
                if task == "mmlu" and not token_level:
                    subj = (subject or "the given subject").replace(
                        "_", " ")
                    prefix = (_MMLU_DESCRIPTION.format(subject=subj)
                              + prefix)
                if per_choice:
                    ctx = [prefix + c for c in ctx]
                elif token_level:
                    ctx = list(prefix) + list(ctx)
                else:
                    ctx = prefix + ctx
            if not per_choice:
                ctx_t = list(ctx) if token_level else tok_fn(ctx)
            for ci in ([ans] if greedy else range(len(choices))):
                if per_choice:
                    ctx_t = tok_fn(ctx[ci])
                ch = choices[ci]
                ch_t = (list(ch) if isinstance(ch, (list, tuple))
                        else tok_fn(ch))
                items.append((di, ci, ctx_t + ch_t, len(ctx_t)))
        scores: Dict[Tuple[int, int], float] = {}
        score_fn = gm if greedy else ll
        for i in range(0, len(items), batch):
            chunk = items[i:i + batch]
            tmax = _bucket(max(len(t) for _, _, t, _ in chunk))
            toks = np.zeros((batch, tmax), np.int32)
            ctx_lens = np.zeros((batch,), np.int32)
            lens = np.zeros((batch,), np.int32)
            for j, (_, _, t, cl) in enumerate(chunk):
                toks[j, :len(t)] = t
                ctx_lens[j] = cl
                lens[j] = len(t)
            out = score_fn(*(torch.from_numpy(a).to(device)
                             for a in (toks, ctx_lens, lens)))
            out = out.float().cpu().numpy()
            for j, (di, ci, _, _) in enumerate(chunk):
                scores[(di, ci)] = float(out[j])
        correct = 0
        for di, (ctx, choices, ans, _) in enumerate(docs):
            if greedy:
                correct += int(scores[(di, ans)] > 0)
            else:
                correct += int(max(range(len(choices)),
                                   key=lambda ci: scores[(di, ci)]) == ans)
        results[task] = correct / max(len(docs), 1)
    return results
