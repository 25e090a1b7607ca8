"""Bundled applications of the PyTorch port.

The reference ships its flagship apps as binding examples (SURVEY.md
§2.32, §2.36).  The port has logistic regression, word2vec and the
skip-gram mixture, each with

- a *parity* training path using push-pull ``Get``/``Add`` (the literal
  reference training-loop shape, SURVEY.md §3.4), and
- a *fused* path where the whole step — pull, compute, push, update —
  runs on the table's device with no host hop,

the DLRM recommender on the row path, LightLDA with its host sweep and
its two device sweeps, and data-parallel ResNet-20 (``apps.resnet``),
whose workers sync through ``ext.torch_ext.TorchParamManager``.

The ``*_worker.py`` scripts are numpy programs over the native runtime
(``native/``), one process per rank of a machine file: the 8-process
LR and word2vec jobs that the fused rates are measured against
(``lr_native_worker``, ``w2v_native_worker``) and ``ServeClient``'s two
benches (``serve_bench_worker``, ``embedding_bench_worker``).
"""

from .dlrm import DLRMRecommender, synthetic_clicks, zipf_ids
from .lightlda import LightLDA, synthetic_documents
from .logistic_regression import LogisticRegression, synthetic_classification
from .resnet import ResNet20DataParallel, build_resnet20, synthetic_cifar
from .skipgram_mixture import SkipGramMixture, synthetic_homonym_corpus
from .word2vec import SkipGram, synthetic_corpus

__all__ = ["DLRMRecommender", "LightLDA", "LogisticRegression",
           "ResNet20DataParallel", "SkipGram", "SkipGramMixture",
           "build_resnet20", "synthetic_cifar", "synthetic_classification",
           "synthetic_clicks", "synthetic_corpus", "synthetic_documents",
           "synthetic_homonym_corpus", "zipf_ids"]
