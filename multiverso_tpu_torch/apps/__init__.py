"""Bundled applications of the PyTorch port.

The reference ships its flagship apps as binding examples (SURVEY.md
§2.32, §2.36).  The port has logistic regression and word2vec, each
with

- a *parity* training path using push-pull ``Get``/``Add`` (the literal
  reference training-loop shape, SURVEY.md §3.4), and
- a *fused* path where the whole step — pull, compute, push, update —
  runs on the table's device with no host hop,

and the DLRM recommender on the row path.  LightLDA, the skip-gram
mixture and ResNet come with ROADMAP.md Queue 1 item 9.
"""

from .dlrm import DLRMRecommender, synthetic_clicks, zipf_ids
from .logistic_regression import LogisticRegression, synthetic_classification
from .word2vec import SkipGram, synthetic_corpus

__all__ = ["DLRMRecommender", "LogisticRegression", "SkipGram",
           "synthetic_classification", "synthetic_clicks",
           "synthetic_corpus", "zipf_ids"]
