#!/usr/bin/env bash
# Parent against this tree on one card, in one process tree:
#   git archive <parent> | tar -x -C build/parent     # from a git checkout
#   bash chip_ab.sh build/parent                      # on the card's host
# Runs chip_smoke.py's slice phase (full-width 25-step generate, s/image
# and its profile) in the order parent, change, change, parent, then this
# tree's bit-slice rows (kernel, plain and _int_mm times at the six
# main-path shapes) on each tree's kernel.  Both trees run this tree's
# chip_smoke.py against their own src/repro_torch, each built in place.
set -euo pipefail
here=$(cd "$(dirname "$0")" && pwd)
parent=$(cd "$1" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
prelude='import sys, torch
sys.path = ["src", sys.argv[1]] + [p for p in sys.path if p not in ("", ".")]
import chip_smoke as c
c.build_kernels()'
slice="$prelude
c.slice_phase(torch)"
rows="$prelude
c.bitslice_rows(torch, torch.Generator(device='cuda').manual_seed(1))"
for who in parent change change parent; do
  if [ "$who" = parent ]; then cd "$parent"; else cd "$here"; fi
  echo "=== slice $who"
  python3 -c "$slice" "$here"
done
for who in parent change; do
  if [ "$who" = parent ]; then cd "$parent"; else cd "$here"; fi
  echo "=== bit-slice rows, $who kernel"
  python3 -c "$rows" "$here"
done
