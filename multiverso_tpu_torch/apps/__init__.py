"""Bundled applications of the PyTorch port.

The reference ships its flagship apps as binding examples (SURVEY.md
§2.32, §2.36).  The port has logistic regression so far, with

- a *parity* training path using push-pull ``Get``/``Add`` (the literal
  reference training-loop shape, SURVEY.md §3.4), and
- a *fused* path where the whole step — pull, compute, push, update —
  runs on the table's device with no host hop.

word2vec comes with the row path (ROADMAP.md Queue 1 item 6); DLRM,
LightLDA, the skip-gram mixture and ResNet with item 9.
"""

from .logistic_regression import LogisticRegression, synthetic_classification

__all__ = ["LogisticRegression", "synthetic_classification"]
