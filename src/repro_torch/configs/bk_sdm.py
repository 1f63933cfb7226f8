"""The paper's workload: BK-SDM-Tiny text-to-image (port of
``repro.configs.bk_sdm``)."""
import dataclasses

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.diffusion.pipeline import PipelineConfig
from repro_torch.diffusion.sampler import DDIMConfig
from repro_torch.diffusion.text_encoder import TextEncoderConfig
from repro_torch.diffusion.unet import UNetConfig
from repro_torch.diffusion.vae import VAEConfig
from repro_torch.kernels.dispatch import KernelPolicy

CONFIG = PipelineConfig(
    unet=UNetConfig(),            # BK-SDM-Tiny geometry (full)
    text=TextEncoderConfig(),     # CLIP ViT-L/14 text tower geometry
    vae=VAEConfig(),
    ddim=DDIMConfig(num_inference_steps=25),
)

SMOKE = PipelineConfig.smoke()


def with_kernel_policy(cfg: PipelineConfig,
                       policy: KernelPolicy) -> PipelineConfig:
    """Pipeline config with the UNet hot path routed per ``policy``."""
    return dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, kernel_policy=policy))


def with_precision(cfg: PipelineConfig,
                   policy: PrecisionPolicy) -> PipelineConfig:
    """Pipeline config with the TIPS/DBSC precision runtime set."""
    return dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, precision=policy))
