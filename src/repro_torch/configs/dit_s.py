"""DiT-S/2 text-conditioned diffusion transformer presets (port of
``repro.configs.dit_s``).

The second denoiser family: patchify -> 12 transformer blocks with adaLN
timestep conditioning -> unpatchify.  The blocks are the UNet's
``_transformer_block``, so PSSA, TIPS, DBSC and temporal patch reuse
apply unchanged; these presets mirror ``configs.bk_sdm`` with the UNet
geometry swapped for ``repro_torch.diffusion.dit.DiTConfig``.
"""
import dataclasses

from repro_torch.configs.bk_sdm import with_kernel_policy, with_precision
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.diffusion.dit import DiTConfig
from repro_torch.diffusion.pipeline import PipelineConfig
from repro_torch.diffusion.sampler import DDIMConfig
from repro_torch.diffusion.text_encoder import TextEncoderConfig
from repro_torch.diffusion.vae import VAEConfig
from repro_torch.kernels.dispatch import KernelPolicy

CONFIG = PipelineConfig(
    unet=DiTConfig(),             # DiT-S/2 geometry (full): 12 x d=384
    text=TextEncoderConfig(),     # CLIP ViT-L/14 text tower geometry
    vae=VAEConfig(),
    ddim=DDIMConfig(num_inference_steps=25),
)

# reduced geometry that runs a full forward pass on a CPU in seconds
SMOKE = dataclasses.replace(PipelineConfig.smoke(),
                            unet=DiTConfig().smoke())

# the kernels on the attention (self + cross), PSXU bitmap and reuse delta
FUSED = with_kernel_policy(CONFIG, KernelPolicy.fused())
SMOKE_FUSED = with_kernel_policy(SMOKE, KernelPolicy.fused())

# the paper's operating points for the precision runtime
ADAPTIVE = with_precision(CONFIG, PrecisionPolicy.adaptive())
PAPER_PRECISION = with_precision(
    CONFIG, PrecisionPolicy(spotting="fixed", ffn_mid=True))
