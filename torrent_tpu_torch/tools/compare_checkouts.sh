#!/usr/bin/env bash
# Compare two checkouts of this repository on one GPU, in turns parent,
# change, change, parent:
#
#   bash torrent_tpu_torch/tools/compare_checkouts.sh PARENT CHANGE OUT
#
# PARENT and CHANGE are unpacked checkouts, for example
# `git archive <commit> | tar -x -C build/parent` in a gitignored
# directory. The script runs CHANGE's chip_smoke.py alone in an empty
# directory (it must fail), then CHANGE's tools/time_merkle.py against each
# checkout's merkle route, then each checkout's own chip_smoke.py, each in
# the four turns. Every run's whole output goes to OUT/alone.log,
# OUT/tm_<turn>_<label>.log and OUT/smoke_<turn>_<label>.log; standard
# output gets the card, each run's exit code and each smoke's last line.
# Exits 1 if a run that must pass failed, or if the lone smoke passed.
set -u
parent=$(realpath "$1")
change=$(realpath "$2")
out=$(realpath -m "$3")
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
fail=0

alone=$(mktemp -d)
cp "$change/chip_smoke.py" "$alone/"
(cd "$alone" && python3 chip_smoke.py) > "$out/alone.log" 2>&1
rc=$?
echo "alone: chip_smoke.py by itself rc=$rc"
[ "$rc" -ne 0 ] || fail=1
rm -rf "$alone"

turns="1:parent 2:change 3:change 4:parent"
for turn in $turns; do
  n=${turn%%:*}
  label=${turn#*:}
  if [ "$label" = parent ]; then dir=$parent; else dir=$change; fi
  python3 "$change/torrent_tpu_torch/tools/time_merkle.py" --root "$dir" --label "$label" \
    > "$out/tm_${n}_${label}.log" 2>&1
  rc=$?
  echo "time_merkle $n $label rc=$rc"
  [ "$rc" -eq 0 ] || fail=1
done
for turn in $turns; do
  n=${turn%%:*}
  label=${turn#*:}
  if [ "$label" = parent ]; then dir=$parent; else dir=$change; fi
  (cd "$dir" && python3 chip_smoke.py) > "$out/smoke_${n}_${label}.log" 2>&1
  rc=$?
  echo "smoke $n $label rc=$rc"
  tail -n 1 "$out/smoke_${n}_${label}.log"
  [ "$rc" -eq 0 ] || fail=1
done
exit $fail
