"""Caption metrics (counterpart of ``change3d_tpu/metrics/caption``):
BLEU-1..4, ROUGE-L, CIDEr-D and METEOR over stringified token ids."""

from change3d_tpu_torch.metrics.caption.bleu import corpus_bleu
from change3d_tpu_torch.metrics.caption.cider import corpus_cider_d
from change3d_tpu_torch.metrics.caption.meteor import corpus_meteor
from change3d_tpu_torch.metrics.caption.rouge import corpus_rouge_l
from change3d_tpu_torch.metrics.caption.score import eval_caption_scores

__all__ = ["corpus_bleu", "corpus_rouge_l", "corpus_cider_d", "corpus_meteor",
           "eval_caption_scores"]
