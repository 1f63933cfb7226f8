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


# the kernels on the attention (self + cross), PSXU bitmap and reuse delta
FUSED = with_kernel_policy(CONFIG, KernelPolicy.fused())
SMOKE_FUSED = with_kernel_policy(SMOKE, KernelPolicy.fused())

# the paper's operating points for the precision runtime: whole-FFN TIPS
# coverage at the measured 44.8 % workload target by per-sample adaptive
# spotting, and the fixed spotting with the FFN's middle in INT12
ADAPTIVE = with_precision(CONFIG, PrecisionPolicy.adaptive())
PAPER_PRECISION = with_precision(
    CONFIG, PrecisionPolicy(spotting="fixed", ffn_mid=True))
