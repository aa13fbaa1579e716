#!/bin/bash
#
# Usage:
#   ./preempt_checkpoint.sh <pid> <seconds_remaining>
#
# Sends SIGHUP to a running sailfish_tpu simulation to force an on-demand
# checkpoint when less than <seconds_remaining> seconds are left in the
# batch job (the runner installs a SIGHUP handler when --checkpoint_file
# is set; see runner._install_sighup_checkpoint).
#
# Counterpart of the reference's utils/pbs_checkpoint.sh -- there the
# script had to scrape per-GPU runner PIDs out of the log; this build
# is one process, so pass its PID directly (e.g. "$!" after launching
# the simulation in the background). Supports PBS and SLURM walltime
# queries.

pid=$1
deadline=$2

if [[ -z "$pid" || -z "$deadline" ]]; then
  echo "usage: $0 <pid> <seconds_remaining>" >&2
  exit 1
fi

remaining_seconds() {
  if [[ -n "$PBS_JOBID" ]]; then
    qstat -f "$PBS_JOBID" | grep Walltime.Remaining | grep -o '[0-9]*'
  elif [[ -n "$SLURM_JOB_ID" ]]; then
    # TimeLeft is [dd-]hh:mm:ss (or "UNLIMITED")
    local t
    t=$(squeue -h -j "$SLURM_JOB_ID" -o %L)
    [[ "$t" == UNLIMITED || -z "$t" ]] && { echo 999999999; return; }
    local days=0
    [[ "$t" == *-* ]] && { days=${t%%-*}; t=${t#*-}; }
    local IFS=:
    set -- $t
    # 10# forces base 10: squeue zero-pads fields ("09:59:30") and
    # bash would otherwise parse 09 as invalid octal
    case $# in
      3) echo $(( days*86400 + 10#$1*3600 + 10#$2*60 + 10#$3 ));;
      2) echo $(( days*86400 + 10#$1*60 + 10#$2 ));;
      *) echo $(( days*86400 + 10#$1 ));;
    esac
  else
    echo "no PBS_JOBID or SLURM_JOB_ID in the environment" >&2
    exit 1
  fi
}

while kill -0 "$pid" 2>/dev/null; do
  remaining=$(remaining_seconds) || exit 1
  echo "remaining seconds: ${remaining}"
  if [[ "$remaining" -lt "$deadline" ]]; then
    echo "deadline reached; sending SIGHUP to ${pid}"
    kill -SIGHUP "$pid"
    exit 0
  fi
  sleep 300
done

echo "process ${pid} exited before the deadline"
