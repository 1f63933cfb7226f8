"""Smoke-sized copies of the configurations: the port's SMOKE presets,
which run on the CPU in seconds, with the cells' schedule shortened."""
import copy
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]

TEXT = {"vocab_size": 256, "max_len": 8, "d_model": 32, "num_layers": 2,
        "num_heads": 4, "d_ff": 64}
VAE = {"channels": [32, 32, 16, 16], "groups": 8}
UNET = {"block_channels": [32, 64, 64, 64], "num_heads": 4,
        "context_dim": 32, "text_len": 8, "time_dim": 64,
        "latent_size": 16, "groups": 8}
DIT = {"latent_size": 16, "hidden_size": 64, "depth": 4, "num_heads": 4,
       "context_dim": 32, "text_len": 8, "time_dim": 64, "groups": 8}
PRESET = {"bksdm-small": ("repro_torch.configs.bk_sdm", "SMOKE", UNET),
          "dit-s2": ("repro_torch.configs.dit_s", "SMOKE", DIT)}


def model(name: str, steps: int = 3) -> dict:
    m = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    module, attr, unet = PRESET[name]
    m = copy.deepcopy(m)
    m["program"].update(module=module, attr=attr)
    m["text"].update(TEXT)
    m["vae"].update(VAE)
    m["unet"].update(unet)
    m["ddim"].update(num_inference_steps=steps,
                     tips_active_iters=max(1, steps * 20 // 25))
    m["trace_rounds"] = 2
    m["check"]["requests"] = 2
    return m


def mix(name: str, slots: int = 2) -> dict:
    x = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    x["slots"] = slots
    if x["arrivals"] == "bursty":
        x.update(burst=slots, gap_s=0.5, ramp_bursts=1)
    return x
