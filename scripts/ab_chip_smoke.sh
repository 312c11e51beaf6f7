#!/usr/bin/env bash
# Parent-versus-change run of chip_smoke.py on one card, in the order
# parent, change, change, parent, so that both sides share the card, its
# power limit and its drift. Run from the repository root on the GPU
# machine:
#
#   scripts/ab_chip_smoke.sh <parent tree> [log directory]
#
# <parent tree> is an unpacked copy of the parent commit in a directory
# that .gitignore lists, made where git is available, for example
#   mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
# Each run's full log goes to <log directory>/<n>-<side>.log (default
# build/ab); its build (ptxas registers and spills), bound, kernel-time
# and slice lines are printed.
set -euo pipefail
parent=$(cd "$1" && pwd)
out=${2:-build/ab}
mkdir -p "$out"
n=0
for side in parent change change parent; do
  n=$((n + 1))
  dir=.
  [ "$side" = parent ] && dir=$parent
  log=$out/$n-$side.log
  if ! (cd "$dir" && python3 chip_smoke.py) >"$log" 2>&1; then
    echo "== $n $side: chip_smoke.py failed"
    tail -n 20 "$log"
    exit 1
  fi
  echo "== $n $side"
  grep -E '^\[(build|bound|time|slice)\]' "$log" | grep -v 'launches' || true
done
