"""Data generation (L1): organic shapes -> meshes -> loadcases ->
solver runs. Host-side, NumPy-only; see shapes.py, loadcases.py,
runner.py. The port's copy of buckgnn_tpu/datagen.
"""

from buckgnn_tpu_torch.datagen.loadcases import (  # noqa: F401
    Loadcase,
    LoadcaseConfig,
    LoadcaseType,
    generate_loadcase,
    generate_model_cases,
)
from buckgnn_tpu_torch.datagen.runner import (  # noqa: F401
    RunnerConfig,
    SolverRunner,
)
from buckgnn_tpu_torch.datagen.shapes import (  # noqa: F401
    ShapeConfig,
    generate_shape_mesh,
)
