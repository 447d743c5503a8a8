"""Caption scoring (counterpart of ``change3d_tpu/metrics/caption/score.py``):
hypotheses and references are token-id (or word) sequences, stringified and
space-joined before scoring, as the reference evaluates them. Returns
{"Bleu_1".."Bleu_4", "METEOR", "ROUGE_L", "CIDEr"}."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from change3d_tpu_torch.metrics.caption.bleu import corpus_bleu
from change3d_tpu_torch.metrics.caption.cider import corpus_cider_d
from change3d_tpu_torch.metrics.caption.meteor import corpus_meteor
from change3d_tpu_torch.metrics.caption.rouge import corpus_rouge_l


def eval_caption_scores(references: List[List[Sequence]], hypotheses: List[Sequence], *,
                        meteor_paraphrase_table: Optional[str] = None,
                        meteor_synonym_table: Optional[str] = None,
                        meteor_function_words: Optional[str] = None) -> Dict[str, float]:
    """The ``meteor_*`` paths (plain or .gz, the jar's formats) turn on
    METEOR's paraphrase and synonym stages and replace its function-word
    list; they matter only when scoring words, not token ids."""
    refs_tok = [[[str(x) for x in r] for r in refs] for refs in references]
    hyps_tok = [[str(x) for x in h] for h in hypotheses]
    bleu = corpus_bleu(refs_tok, hyps_tok)
    meteor = corpus_meteor([[" ".join(r) for r in refs] for refs in refs_tok],
                           [" ".join(h) for h in hyps_tok],
                           paraphrase_table=meteor_paraphrase_table,
                           synonym_table=meteor_synonym_table,
                           function_words=meteor_function_words)
    return {"Bleu_1": bleu[0], "Bleu_2": bleu[1], "Bleu_3": bleu[2], "Bleu_4": bleu[3],
            "METEOR": meteor, "ROUGE_L": corpus_rouge_l(refs_tok, hyps_tok),
            "CIDEr": corpus_cider_d(refs_tok, hyps_tok)}
