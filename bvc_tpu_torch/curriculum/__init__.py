from bvc_tpu_torch.curriculum.driver import run_curriculum, stage_plan  # noqa: F401
from bvc_tpu_torch.curriculum.presets import CURRICULA, FAMILY_PRESETS  # noqa: F401
