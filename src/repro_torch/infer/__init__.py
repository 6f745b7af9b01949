"""repro_torch.infer: Byzantine-robust statistical inference for RCSL.

The paper's asymptotic-normality result made computable: plug-in
sandwich covariances built from robustly aggregated per-machine
statistics (``sandwich``), and the Monte-Carlo coverage harness of the
Section 4 experiments (``coverage``), batched over replications.

    from repro_torch.infer import infer, coverage_run
    res = infer(problem, shards, theta_hat, estimator="vrmom", level=0.95)
    res.ci.lower, res.ci.upper          # per-coordinate CIs
    cell = coverage_run(model="linear", attack="gaussian", alpha=0.1)
    cell.summary()["coverage"]          # ~ 0.95
"""
from .coverage import CoverageCell, coverage_run
from .sandwich import (CIResult, InferenceResult, MachineStats, bvn_cdf,
                       confidence_intervals, contamination_inflation,
                       corrupt_stats, cov_factor, infer, machine_stats,
                       mom_cov_factor, robust_moments, sandwich_cov,
                       trimmed_mean_variance_factor, vrmom_cov_factor)

__all__ = [
    "bvn_cdf",
    "vrmom_cov_factor",
    "mom_cov_factor",
    "cov_factor",
    "trimmed_mean_variance_factor",
    "contamination_inflation",
    "MachineStats",
    "machine_stats",
    "corrupt_stats",
    "robust_moments",
    "sandwich_cov",
    "confidence_intervals",
    "CIResult",
    "InferenceResult",
    "infer",
    "CoverageCell",
    "coverage_run",
]
