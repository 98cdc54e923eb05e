from repro_torch.optim.adamw import (AdamWConfig, OptState,  # noqa: F401
                                     apply_updates, global_norm,
                                     init_opt_state)
from repro_torch.optim.schedule import ScheduleConfig, lr_at  # noqa: F401
