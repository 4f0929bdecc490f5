from repro_torch.checkpoint.io import (save_checkpoint, load_checkpoint,
                                       load_metadata, latest_step,
                                       checkpoint_valid, valid_steps)
