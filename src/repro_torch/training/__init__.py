from repro_torch.training.grad_compression import (  # noqa: F401
    compress_tree_psum, compressed_psum)
from repro_torch.training.optimizer import (  # noqa: F401
    AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm)
from repro_torch.training.train_loop import (  # noqa: F401
    TrainConfig, make_train_step, train)
