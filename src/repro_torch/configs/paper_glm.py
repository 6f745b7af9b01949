"""The paper's own simulation configurations (Section 4).

Not architectures: these parameterize the GLM experiments of the paper's
tables (``repro.configs.paper_glm``). ``p`` covariates, ``m_workers``
workers plus the master, ``n_per_machine`` samples each, Toeplitz
covariates with correlation ``toeplitz_rho``; ``reps`` replications and
the RCSL stopping rule ``tol`` of Section 4.2.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GLMConfig:
    name: str
    model: str           # linear | logistic
    p: int = 30
    n_per_machine: int = 1000
    m_workers: int = 100
    K: int = 10
    toeplitz_rho: float = 0.5
    mu_x: float = 0.0
    reps: int = 500      # paper setting
    tol: float = 1e-4    # adaptive stopping (Section 4.2)


PAPER_LINREG = GLMConfig(name="paper-linreg", model="linear")
PAPER_LOGREG_BALANCED = GLMConfig(name="paper-logreg-balanced",
                                  model="logistic", mu_x=0.0)
PAPER_LOGREG_IMBALANCED = GLMConfig(name="paper-logreg-imbalanced",
                                    model="logistic", mu_x=0.5)
