from arslam.solve.lm import LMConfig, LMState, lm_solve  # noqa: F401
from arslam.solve.residuals import linearize, total_cost  # noqa: F401
from arslam.solve.batch import solve as solve_batch  # noqa: F401
from arslam.solve.batch import solve_incremental  # noqa: F401
from arslam.solve.localize import localize_many  # noqa: F401
