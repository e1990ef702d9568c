#!/bin/bash
# Time chip_smoke.py's lm_mesh_families phase of two trees in one run on
# one card, in turns parent, change, change, parent, and print each run's
# 2 x 2 decode ms a step (hymba-1.5b, mamba2-130m) and the phase's
# seconds.  Run from the repository's root, with the parent unpacked into
# a directory that .gitignore lists:
#
#   git archive <parent> | tar -x -C build/parent
#   bash tools/mesh_families_ab.sh [build/parent] [build/ab]
#
# Each run's whole output goes to <out>/ab_<tree>.log.
parent=${1:-build/parent}
out=$(mkdir -p "${2:-build/ab}" && cd "${2:-build/ab}" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for t in parent change change parent; do
  if [ $t = parent ]; then d=$parent; else d=.; fi
  (cd "$d" && python -c "
import sys, time, torch
sys.path.insert(0, '.')
import chip_smoke as cs
cs.setup_path()
t = time.perf_counter()
cs.phase_lm_mesh_families(torch.cuda.get_device_name(0))
print('PHASE_SECONDS', time.perf_counter() - t)
") > "$out/ab_$t.log" 2>&1 || echo "FAILED $t"
  grep -h '"phase": "lm_mesh_families"' "$out/ab_$t.log" | python -c "
import json, sys
d = json.loads(sys.stdin.read())
h, s = d['hybrid']['serve'], d['ssm']
print('$t', 'hymba', h['decode_step_ms'], h['decode_ms_quantiles'],
      'mamba2', s['mesh']['decode_step_ms'], s['mesh']['decode_ms_quantiles'],
      'mamba2_1x1', s['one_device']['decode_step_ms'], 'seconds',
      d['seconds'])
"
done
