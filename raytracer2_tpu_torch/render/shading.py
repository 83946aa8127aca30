"""Shading output glue, port of store_shading_output from
raytracer2_tpu/render/shading.py (ShadingHelpers.glsl:61-88). Light-sample
shading and visibility rays come with the DI slice (ROADMAP queue A).
"""

from __future__ import annotations

import torch


def store_shading_output(
    diffuse_img: torch.Tensor,  # [H, W, 3] prior
    specular_img: torch.Tensor,
    diffuse: torch.Tensor,  # [H, W, 3] new contribution
    specular: torch.Tensor,
    is_first_pass: bool,
    enable_accumulation: int,
    blend_factor: float,
    write_mask: torch.Tensor | None = None,  # lanes that execute the store
    correct_specular_accumulation: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Functional StoreShadingOutput (ShadingHelpers.glsl:61-88).

    QUIRK preserved by default: in accumulation mode the reference blends
    the NEW diffuse into BOTH outputs using priorDiffuse (copy-paste bug,
    ShadingHelpers.glsl:72-73). correct_specular_accumulation=True
    accumulates specular properly instead (the RMSE gate's setting)."""
    if enable_accumulation:
        new_diffuse = diffuse_img + (diffuse - diffuse_img) * blend_factor
        if correct_specular_accumulation:
            new_specular = (specular_img
                            + (specular - specular_img) * blend_factor)
        else:
            new_specular = new_diffuse  # [sic] mix(priorDiffuse, diffuse, t)
    elif not is_first_pass:
        new_diffuse = diffuse_img + diffuse
        new_specular = specular_img + specular
    else:
        new_diffuse = diffuse
        new_specular = specular
    if write_mask is not None:
        m = write_mask[..., None]
        new_diffuse = torch.where(m, new_diffuse, diffuse_img)
        new_specular = torch.where(m, new_specular, specular_img)
    return new_diffuse, new_specular
