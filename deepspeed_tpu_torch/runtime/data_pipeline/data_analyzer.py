"""Offline data analysis for curriculum learning (copy of
deepspeed_tpu/runtime/data_pipeline/data_analyzer.py for the PyTorch port).

Reference analog: ``DataAnalyzer`` (runtime/data_pipeline/data_sampling/
data_analyzer.py:417 LoC): map user metric functions over the whole corpus
(parallelizable by worker shards), then build the two artifacts curriculum
sampling needs per metric:

  * ``<metric>_sample_to_metric.npy`` — metric value per sample index
  * ``<metric>_metric_to_sample.npy`` — sample indices sorted by metric
    (ascending difficulty: the curriculum pool is a prefix of this order)

``DeepSpeedDataSampler`` consumes the sample_to_metric array directly as
its difficulty vector.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger


def seqlen_metric(sample) -> float:
    """The stock difficulty metric (reference data_analyzer's seqlen):
    number of tokens in the sample."""
    return float(np.asarray(sample).size)


def vocab_rarity_metric(sample, token_freq: Optional[np.ndarray] = None) -> float:
    """Mean negative log token frequency (reference vocab rarity metric)."""
    arr = np.asarray(sample).reshape(-1)
    if token_freq is None:
        return 0.0
    p = token_freq[arr] / max(token_freq.sum(), 1)
    return float(-np.log(np.maximum(p, 1e-12)).mean())


class DataAnalyzer:
    def __init__(self, dataset, metric_names: Sequence[str] = ("seqlen",),
                 metric_functions: Optional[Sequence[Callable]] = None,
                 output_path: str = "data_analysis",
                 num_workers: int = 1, worker_id: int = 0,
                 num_threads: int = 4):
        self.dataset = dataset
        self.metric_names = list(metric_names)
        if metric_functions is not None:
            self.metric_functions = list(metric_functions)
        elif self.metric_names == ["seqlen"]:
            self.metric_functions = [seqlen_metric]
        else:
            # defaulting every named metric to seqlen would silently produce
            # wrong curricula
            raise ValueError(
                f"metric_functions required for metric_names="
                f"{self.metric_names} (only the default ['seqlen'] has an "
                f"implicit function)")
        assert len(self.metric_names) == len(self.metric_functions)
        self.output_path = output_path
        self.num_workers = max(num_workers, 1)
        self.worker_id = worker_id
        self.num_threads = max(num_threads, 1)

    # ------------------------------------------------------------ map phase
    def _worker_range(self):
        n = len(self.dataset)
        per = (n + self.num_workers - 1) // self.num_workers
        lo = min(self.worker_id * per, n)  # trailing workers get empty shards
        return lo, min(lo + per, n)

    def run_map(self) -> Dict[str, str]:
        """Compute this worker's shard of every metric; returns paths of the
        partial files (reference run_map)."""
        lo, hi = self._worker_range()
        os.makedirs(self.output_path, exist_ok=True)
        out = {}
        for name, fn in zip(self.metric_names, self.metric_functions):
            vals = np.empty(hi - lo, np.float64)

            def compute(j):
                vals[j - lo] = fn(self.dataset[j])

            if self.num_threads > 1:
                with cf.ThreadPoolExecutor(self.num_threads) as pool:
                    list(pool.map(compute, range(lo, hi)))
            else:
                for j in range(lo, hi):
                    compute(j)
            path = os.path.join(
                self.output_path,
                f"{name}_worker{self.worker_id}_partial.npy")
            np.save(path, vals)
            out[name] = path
            logger.info(f"data analyzer: {name} [{lo}:{hi}] done")
        return out

    # --------------------------------------------------------- reduce phase
    def run_reduce(self) -> Dict[str, Dict[str, str]]:
        """Merge all workers' partials into the curriculum artifacts
        (reference run_reduce)."""
        out = {}
        for name in self.metric_names:
            parts = []
            for w in range(self.num_workers):
                p = os.path.join(self.output_path,
                                 f"{name}_worker{w}_partial.npy")
                if not os.path.exists(p):
                    raise FileNotFoundError(
                        f"missing partial for worker {w}: {p} (run run_map "
                        f"on every worker first)")
                parts.append(np.load(p))
            sample_to_metric = np.concatenate(parts)
            metric_to_sample = np.argsort(sample_to_metric, kind="stable")
            s2m = os.path.join(self.output_path,
                               f"{name}_sample_to_metric.npy")
            m2s = os.path.join(self.output_path,
                               f"{name}_metric_to_sample.npy")
            np.save(s2m, sample_to_metric)
            np.save(m2s, metric_to_sample)
            out[name] = {"sample_to_metric": s2m, "metric_to_sample": m2s}
        return out

    def run(self) -> Dict[str, Dict[str, str]]:
        """Single-process convenience: map + reduce."""
        self.run_map()
        return self.run_reduce()


def load_difficulties(output_path: str, metric_name: str) -> np.ndarray:
    """The DeepSpeedDataSampler's difficulty vector for a metric."""
    return np.load(os.path.join(output_path,
                                f"{metric_name}_sample_to_metric.npy"))
