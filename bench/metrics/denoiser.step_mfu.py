"""Share (%) of the card's dense bf16 peak in the dense FLOPs of the
images' work (occupied rows through the denoiser, both guidance halves;
the prompts encoded; the images decoded) over the wall time of the
window's rounds outside the profiled ones."""
import peaks


def read(run):
    idx = run.window_rounds()
    if len(idx) < 2:
        return None
    rounds = run.rec.rounds
    span = rounds[idx[-1]][0] - rounds[idx[0]][0]
    flops = sum(run.round_work(i) for i in idx[:-1])
    return 100.0 * flops / span / peaks.MFU_PEAK if span > 0 else None
