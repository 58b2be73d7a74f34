from repro_torch.models.model import (Model, build_model,  # noqa: F401
                                      input_specs, make_step_fn)
