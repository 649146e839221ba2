from truetrace_tpu_torch.diff.render_grad import (  # noqa: F401
    get_material_params, get_scene_params, render_loss_and_grad,
    set_material_params, set_scene_params)
