#!/usr/bin/env bash
# Parent against this tree on one card, in one process tree:
#   git archive <parent> | tar -x -C build/parent     # from a git checkout
#   bash chip_ab.sh build/parent [pssa|ssd|cross]     # on the card's host
# pssa (the default): chip_smoke.py's slice phase (full-width 25-step
# generate, s/image and its profile) in the order parent, change, change,
# parent, then this tree's PSSA rows (kernel, plain and bound at the six
# shapes, the checks included) on each tree's kernel; a kernel without the
# guard band's counter reads 0 there.
# ssd: chip_smoke.py's serve phase (mamba2-130m at full width: prefill s,
# decode ms, the route and carry checks and the profiles) in the same
# order, then this tree's SSD scan rows (the five rows, checks included) on
# each tree's kernel.
# cross: the slice phase as pssa does, then this tree's cross-attention
# rows (the three main shapes and the ragged one, checks included) on each
# tree's kernel, through the contiguous 3-D call both trees have.
# Both trees run this tree's chip_smoke.py against their own
# src/repro_torch, each built in place.
set -euo pipefail
here=$(cd "$(dirname "$0")" && pwd)
parent=$(cd "$1" && pwd)
mode=${2:-pssa}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
prelude='import sys, torch
sys.path = ["src", sys.argv[1]] + [p for p in sys.path if p not in ("", ".")]
import chip_smoke as c
c.build_kernels()'
case "$mode" in
  pssa)
    run="$prelude
c.slice_phase(torch)"
    rows="$prelude
import repro_torch.kernels.pssa_attention.kernel as k
if not hasattr(k, 'band_count'):
    k.band_count, k.band_reset = (lambda: 0), (lambda: None)
c.pssa_rows(torch, torch.Generator(device='cuda').manual_seed(1234))"
    what="slice"; rows_what="PSSA rows" ;;
  cross)
    run="$prelude
c.slice_phase(torch)"
    rows="$prelude
c.cross_rows(torch, torch.Generator(device='cuda').manual_seed(1234))"
    what="slice"; rows_what="cross-attention rows" ;;
  ssd)
    run="$prelude
c.serve_phase(torch)"
    rows="$prelude
c.ssd_scan_rows(torch, torch.Generator(device='cuda').manual_seed(5678))"
    what="serve"; rows_what="SSD scan rows" ;;
  *)
    echo "chip_ab.sh: unknown mode $mode (pssa, ssd or cross)" >&2; exit 2 ;;
esac
for who in parent change change parent; do
  if [ "$who" = parent ]; then cd "$parent"; else cd "$here"; fi
  echo "=== $what $who"
  python3 -c "$run" "$here"
done
for who in parent change; do
  if [ "$who" = parent ]; then cd "$parent"; else cd "$here"; fi
  echo "=== $rows_what, $who kernel"
  python3 -c "$rows" "$here"
done
