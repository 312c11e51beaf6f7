#!/usr/bin/env bash
# Parent-versus-change run of chip_smoke.py (or another script of the
# repository) on one card, in the order parent, change, change, parent, so
# that both sides share the card, its power limit and its drift. Run from
# the repository root on the GPU machine:
#
#   scripts/ab_chip_smoke.sh <parent tree> [log directory] [script]
#
# <parent tree> is an unpacked copy of the parent commit in a directory
# that .gitignore lists, made where git is available, for example
#   mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
# [script] is a path relative to the repository root, run with python3 in
# each tree (default chip_smoke.py; scripts/profile_torch_mapping.py gives
# the per-step wall times, device times and launch counts). Each run's
# full log goes to <log directory>/<n>-<side>.log (default build/ab); its
# build (ptxas registers and spills), bound, kernel-time, slice and
# per-step profile lines are printed.
set -euo pipefail
parent=$(cd "$1" && pwd)
out=${2:-build/ab}
script=${3:-chip_smoke.py}
mkdir -p "$out"
n=0
for side in parent change change parent; do
  n=$((n + 1))
  dir=.
  [ "$side" = parent ] && dir=$parent
  log=$out/$n-$side.log
  if ! (cd "$dir" && python3 "$script") >"$log" 2>&1; then
    echo "== $n $side: $script failed"
    tail -n 20 "$log"
    exit 1
  fi
  echo "== $n $side"
  grep -E '^\[(build|bound|time|slice|wall|profile)\]' "$log" \
    | grep -v 'launches:' || true
done
