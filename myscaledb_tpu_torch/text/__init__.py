"""Full-text and hybrid search: BM25 (``bm25.py``) and the RSF/RRF fusion
of a vector and a text candidate list (``fusion.py``)."""

from myscaledb_tpu_torch.text.bm25 import BM25Index, tokenize
from myscaledb_tpu_torch.text.fusion import (relative_score_fusion,
                                             reciprocal_rank_fusion)

__all__ = ["BM25Index", "tokenize", "relative_score_fusion",
           "reciprocal_rank_fusion"]
