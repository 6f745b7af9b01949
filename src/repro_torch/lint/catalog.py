"""Catalog of every rule and audit check of the port's lint
(``repro.lint.catalog``' port, DESIGN.md §10).

Pure data, stdlib only. Layer-1 AST rules (RL0xx) are implemented in
:mod:`repro_torch.lint.rules`; layer-2 auditor checks (RL2xx) in
:mod:`repro_torch.lint.auditor`. RL000 is the meta-rule guarding the
waiver mechanism itself. Each id keeps ``repro``'s number and name; the
invariant is the port's own (torch calls, CUDA graph capture, the
port's entry points). ``repro``'s RL005 and RL006 read Pallas source and
have no counterpart here: they stand in :data:`NOT_PORTED` with the
reason, and are not registered as rules.
"""
from __future__ import annotations

from typing import NamedTuple

__all__ = ["RuleInfo", "AST_RULES", "AUDIT_CHECKS", "ALL_IDS", "NOT_PORTED",
           "info"]


class RuleInfo(NamedTuple):
    id: str
    name: str
    invariant: str
    established: str  # the DESIGN section that set the invariant


AST_RULES = (
    RuleInfo(
        "RL000", "suppression-without-reason",
        "Every `# reprolint-torch: disable=RLxxx` waiver must carry a "
        "reason; an unexplained or stale suppression is itself a finding. "
        "The tag is the port's own: repro's lint and this one never read "
        "each other's waivers.",
        "DESIGN §10"),
    RuleInfo(
        "RL001", "direct-aggregation-bypass",
        "All robust aggregation routes through the hashable "
        "core.estimator.Estimator dispatch: no direct torch.median/"
        "nanmedian/quantile/nanquantile call, no Tensor.median/quantile "
        "method call, and no core.aggregators access at call sites "
        "outside the estimator layer itself.",
        "DESIGN §7"),
    RuleInfo(
        "RL002", "kv-head-repeat",
        "GQA K/V tensors are never repeat_interleave-d, .repeat-ed or "
        ".expand(...).reshape-d to the query-head count in models/ or "
        "kernels/: grouped attention (B2, B3) keeps K/V cache traffic at "
        "Hkv, not H.",
        "DESIGN §8"),
    RuleInfo(
        "RL003", "capture-unsafe-python",
        "A step captured as a CUDA graph (the functions called in a "
        "`with torch.cuda.graph(...)` body, and what they call that "
        "resolves in the same file or through an import into "
        "repro_torch) reads no device value on the host and copies "
        "nothing host to device: no .item()/.tolist()/.cpu()/.numpy(), "
        "no int()/float()/bool() of a tensor-valued name, no if/while on "
        "one, no torch.tensor/as_tensor/from_numpy (shape/ndim/dtype/"
        "device/size() reads and `is None` tests are static and exempt).",
        "DESIGN §1-§2 (jit discipline)"),
    RuleInfo(
        "RL004", "unhashable-static",
        "Config-like specs (\\*Config/\\*Spec/Estimator/Sampling/"
        "\\*Setup) that key caches (captured steps, kernel tables) must "
        "be hashable: dataclasses frozen=True, no list/dict/set-typed "
        "fields.",
        "DESIGN §7"),
    RuleInfo(
        "RL007", "wall-clock-outside-obs",
        "Library code under src/repro_torch/ never reads the wall clock "
        "directly (time.time/perf_counter/monotonic/...): timings route "
        "through repro_torch.obs.metrics.now(), the single allowed call "
        "site.",
        "DESIGN §11"),
)

AUDIT_CHECKS = (
    RuleInfo(
        "RL201", "rrs-wire-shapes",
        "The multi-rank RRS wire keeps every leaf's shape (minus the "
        "worker dim) and dtype for every worker count of the group. "
        "Off a process group of two or more ranks the check skips.",
        "DESIGN §3"),
    RuleInfo(
        "RL202", "symmetric-triangle-wire",
        "aggregate_symmetric_stacked puts exactly p(p+1)/2 upper-"
        "triangle coordinates on the wire and returns a [p, p] matrix "
        "of the input dtype.",
        "DESIGN §9"),
    RuleInfo(
        "RL203", "coordinatewise-gate",
        "Whole-vector estimators (geometric_median, Krum) are refused on "
        "the stacked and serve wires, and degenerate trimmed_mean specs "
        "raise instead of silently meaning mean.",
        "DESIGN §7"),
    RuleInfo(
        "RL204", "wire-dtype-discipline",
        "Robust aggregation of a bf16 gradient stack returns bf16 "
        "(f32 inside, no silent upcast of the output); robust decode "
        "logits are exactly f32.",
        "DESIGN §3/§6"),
    RuleInfo(
        "RL205", "worker-divisibility-guard",
        "robust_dot and the inloop train step refuse batches the worker "
        "count does not divide, instead of degrading to a non-robust "
        "grouping.",
        "DESIGN §2"),
    RuleInfo(
        "RL206", "train-step-shapes",
        "A make_train_step stacked-auto step keeps every param and "
        "opt-state shape and dtype and gives a scalar loss.",
        "DESIGN §1"),
    RuleInfo(
        "RL207", "serve-cache-roundtrip",
        "ServeEngine prefill gives [B, V] logits, and a robust pool "
        "decode returns the cache tree with the same structure, shapes "
        "and dtypes.",
        "DESIGN §6-§7"),
    RuleInfo(
        "RL208", "sandwich-ci-shapes",
        "The plug-in sandwich CI path (machine stats -> robust moments "
        "-> Theorem-4 factor -> intervals) gives [p] intervals and a "
        "[p, p] covariance.",
        "DESIGN §9"),
    RuleInfo(
        "RL209", "capture-stability",
        "Equal-valued but freshly constructed static specs (Estimator, "
        "ConsensusConfig, FaultPlan, ArchConfig, RobustDecodeConfig, "
        "Sampling) are equal and hash alike, and on the card a second "
        "generate or decode_pool with a fresh equal Sampling replays "
        "the captured step: one entry in engine.graphs/pool_graphs, no "
        "new StepGraph.",
        "DESIGN §7"),
    RuleInfo(
        "RL210", "consensus-wire",
        "The consensus wire keeps every leaf's shape and dtype through "
        "the round loop (fault-free and faulty plans) and refuses "
        "n <= 5f configurations.",
        "DESIGN §13"),
    RuleInfo(
        "RL211", "adaptive-state-carry",
        "The adaptive aggregation state is an explicit carry: "
        "init_state/apply_adaptive round-trip with fixed shapes and "
        "dtypes, repro_torch.core.adaptive holds no mutable module-level "
        "state, and non-adaptive estimators refuse to create a carry.",
        "DESIGN §14"),
)

# repro's rules with no counterpart in the port, and why
NOT_PORTED = (
    RuleInfo(
        "RL005", "impure-index-map",
        "Not ported: it reads Pallas BlockSpec index maps. The port's "
        "kernels are CUDA C++ under kernels/csrc/, which a Python AST "
        "cannot read.",
        "DESIGN §7-§8 kernel discipline"),
    RuleInfo(
        "RL006", "unmasked-padded-load",
        "Not ported: it reads jnp.pad before pl.pallas_call. The port's "
        "kernels mask their tails in CUDA C++ under kernels/csrc/, which "
        "a Python AST cannot read.",
        "DESIGN §8 mask discipline"),
)

ALL_IDS = tuple(r.id for r in AST_RULES + AUDIT_CHECKS)

_BY_ID = {r.id: r for r in AST_RULES + AUDIT_CHECKS + NOT_PORTED}


def info(rule_id: str) -> RuleInfo:
    return _BY_ID[rule_id]
