from optiland_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    prng_to_state,
    restore_checkpoint,
    save_checkpoint,
    state_to_prng,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint",
           "prng_to_state", "state_to_prng"]
