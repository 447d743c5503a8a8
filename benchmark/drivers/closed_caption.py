"""Closed loop of change captioning: ``CaptionPredictor.caption_u8`` called
back to back on batches of uint8 pairs held on the host, drawn at set-up
from a seeded pool (traffic keys: ``batch``, ``pool``, ``batches``,
``beam``). Reports ``captions_per_s``: captions completed over the
whole window. The instance's ``decode`` is wrapped to keep its tokens and scores; in
a traced run it is also timed with a synchronise on each side (span
``caption_decode``).

Every caption of the window is checked: the plain fp32 reference encodes
each pair and scores the served tokens teacher-forced; the number is the
widest gap by which a served token's reference logit lies below the
reference's best at its position (greedy tokens: beam 1), and the mean
gap per token between the score the search reported for a caption and the
reference's summed log-probability of its tokens. The tokens and scores
are kept from the instance's ``decode``; the captions are held to their
tokens' words.

Variants (the controls and a planted fault, never run by the benchmark
itself): ``fp8`` the reference with
float8 products read at each position of the served tokens, where its own
first choice and its own score of them are judged; ``token_altered`` one
token of each decoded batch changed where the search produces it.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.benchlib import compare, inputs, program
from benchmark.benchlib.runner import Check, Window
from benchmark.reference.change3d import Change3DRef, make_params, no_tf32, normalize_u8
from benchmark.work import flops


class Driver:
    def __init__(self, cell, seed: int, device: str, variant=None):
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.limits, self.device, self.variant = cfg, cell.limits, device, variant
        self.batch, self.max_len = tr["batch"], cfg["max_caption_len"]
        self.params = make_params(cfg, seed, device)
        self.pre, self.post, _ = inputs.image_pairs(seed, tr["pool"], cfg["image_size"])
        draw = inputs.rng(seed, "batches")
        self.ids = [np.sort(draw.choice(tr["pool"], self.batch, replace=False))
                    for _ in range(tr["batches"])]
        self.batches = [(self.pre[i], self.post[i]) for i in self.ids]
        self.words = program.word_map(cfg["vocab_size"])
        from change3d_tpu_torch.inference import CaptionPredictor

        model = program.build_model(cfg, self.params, device)
        self.predictor = CaptionPredictor(model, self.words, beam_size=tr["beam"],
                                          compute_dtype=getattr(torch, cfg["inference_dtype"]),
                                          device=device)
        for pre, post in self.batches[:2]:
            self.predictor.caption_u8(pre, post)
        self.answers = []

    def _steps(self, captions) -> int:
        """Decode steps the batch needed: until every row emitted <end>, at
        most max_len - 1."""
        return min(self.max_len - 1, max(len(c.split()) + 1 for c in captions))

    def window(self, seconds: float, tracer) -> Window:
        sync = torch.cuda.synchronize if self.device == "cuda" else (lambda: None)
        spans = {"caption_decode": []}
        decode, decoded = self.predictor.decode, []

        def kept(*a, **kw):
            """The instance's decode, its output kept (and, traced, timed)."""
            if tracer.enabled:
                sync()
                t = time.perf_counter()
            out = decode(*a, **kw)
            if self.variant == "token_altered":
                tokens = out[0].clone()
                tokens[0, 3] = (tokens[0, 3] + 1) % self.cfg["vocab_size"]
                out = (tokens, out[1])
            if tracer.enabled:
                sync()
                spans["caption_decode"].append(time.perf_counter() - t)
            decoded.append(out)
            return out

        self.predictor.decode = kept
        caption = self.predictor.caption_u8
        n, steps, t0 = 0, 0, time.perf_counter()
        while True:
            k = n % len(self.batches)
            out = caption(*self.batches[k])
            self.answers.append((self.ids[k], out, decoded[-1]))
            steps += self._steps(out)
            n += 1
            now = time.perf_counter()
            tracer.tick(now, t0, n * self.batch, sync)
            if now - t0 >= seconds:
                break
        elapsed = now - t0
        print(f"caption: {n} calls, {steps / n} decode steps a call", file=sys.stderr)
        cfg, samples = self.cfg, n * self.batch
        total = (samples * (flops.encoder_flops(cfg) + flops.caption_memory_kv_flops(cfg))
                 + steps * self.batch * flops.caption_step_flops(cfg, self.max_len))
        work = {"flops": total,
                "fused_least_s_per_sample": flops.fused_least_s(cfg, self.batch) / self.batch}
        return Window(samples, 0, {"captions_per_s": samples / elapsed}, samples, elapsed,
                      spans, {}, work)

    def release(self) -> None:
        del self.predictor
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def _served(self):
        """Every answer's rows: (pair, decoded tokens [<start>, ...], the
        served-token count up to and with the first <end>, the reported
        score), and how many captions differ from their tokens' words."""
        words = {i: w for w, i in self.words.items()}
        special = {self.words[w] for w in ("<start>", "<end>", "<pad>")}
        end, rows, unlike = self.words["<end>"], [], 0
        for ids, caps, (tokens, scores) in self.answers:
            for i, cap, toks, sc in zip(ids, caps, tokens.cpu().tolist(),
                                        scores.float().cpu().tolist()):
                n = toks.index(end, 1) if end in toks[1:] else len(toks) - 1
                rows.append((int(i), toks, n, sc))
                unlike += cap != " ".join(words[t] for t in toks if t not in special)
        return rows, unlike

    @torch.no_grad()
    def check(self):
        """``token_gap_logit``: the widest gap of a served token below the
        reference's best at its position; ``score_gap``: the mean over the
        captions of the gap per served token between a caption's reported
        score and the reference's summed log-probability of its tokens;
        ``captions_unlike_tokens``: captions whose words are not their
        decoded tokens'."""
        no_tf32()
        rows, unlike = self._served()
        ref = Change3DRef(self.cfg, self.params)
        low = Change3DRef(self.cfg, self.params, quant="fp8") if self.variant == "fp8" else None
        pre = torch.from_numpy(self.pre).to(self.device)
        post = torch.from_numpy(self.post).to(self.device)
        memory = torch.from_numpy(compare.reference_in_blocks(
            lambda s: ref.memory(normalize_u8(pre[s], "cc"), normalize_u8(post[s], "cc")),
            len(self.pre))).to(self.device)
        gap, score_gaps = 0.0, []
        for i in range(0, len(rows), 128):
            block = rows[i:i + 128]
            idx = torch.tensor([r[0] for r in block], device=self.device)
            served = torch.tensor([r[1] for r in block], device=self.device)
            n = torch.tensor([r[2] for r in block], device=self.device)
            z = ref.caption_logits(memory[idx], served)
            judged = served
            got = torch.tensor([r[3] for r in block], device=self.device)
            if low is not None:
                # The control at each position of the served tokens: its own
                # first choice is judged, and its own score of the tokens.
                m = low.memory(normalize_u8(pre[idx], "cc"), normalize_u8(post[idx], "cc"))
                zl = low.caption_logits(m, served)
                got = compare.token_scores(zl, served, n)
                judged = torch.cat([served[:, :1], zl.argmax(-1)[:, :-1]], dim=1)
            gap = max(gap, float(compare.token_gaps(z, judged, n).max()))
            score_gaps += ((got - compare.token_scores(z, served, n)).abs() / n).tolist()
        return [Check("token_gap_logit", gap, self.limits["token_gap_logit"]),
                Check("score_gap", float(np.mean(score_gaps)), self.limits["score_gap"]),
                Check("captions_unlike_tokens", float(unlike), 0.0)]
