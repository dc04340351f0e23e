"""Experiment launcher: writes a job's run script and runs it
(counterpart of the JAX package's ``utils/exp_launcher.py``).

As the reference's utils/exp_driver.py: a job directory
``{job_root}/{job}_{timestamp}/{logs,outputs,run.sh}``, a run script that
calls the driver with the recommended mode flags (exp_driver.py:110-113:
cache_creation_epochs 2, execution_mode computation, computation_mode
frequency_cache, load_balance_scheme federated, kept here as defaults),
run on this host or handed to SLURM.

The port runs one process a GPU, so the script starts the driver under
``torchrun --nproc_per_node "$NPROC"``; ``NPROC`` is read when the script
runs and defaults to the host's GPU count. With one GPU the driver trains
on one card. The script is the same on every host and holds no
multi-node rendezvous: under ``sbatch`` it runs once, on the first node.
"""

from __future__ import annotations

import os
import stat
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

RUN_TEMPLATE = """#!/bin/bash
set -e
cd {repo_root}
export PYTHONOPTIMIZE=1
{env_exports}
NPROC=${{NPROC:-$(python -c 'import torch; print(torch.cuda.device_count())')}}
torchrun --nproc_per_node "$NPROC" \\
    -m salient_plusplus_tpu_torch.driver {dataset} {job} \\
    --output_root {out_dir} \\
{flag_lines}
"""

SLURM_HEADER = """#SBATCH --job-name={job}
#SBATCH --nodes={nodes}
#SBATCH --output={log_dir}/%x_%j.out
"""

RECOMMENDED_FLAGS = {
    "cache_creation_epochs": 2,
    "execution_mode": "computation",
    "computation_mode": "frequency_cache",
    "load_balance_scheme": "federated",
}


@dataclass
class ExpLauncher:
    job_root: str = "experiments"
    repo_root: str = "."
    env: Dict[str, str] = field(default_factory=dict)

    def prepare(self, dataset: str, job: str,
                flags: Optional[Dict[str, object]] = None,
                slurm_nodes: Optional[int] = None) -> str:
        """Write the job directory and its executable ``run.sh``; returns
        the directory. ``flags`` add to or override RECOMMENDED_FLAGS (a
        list becomes a comma-separated value); ``slurm_nodes`` adds the
        SBATCH header."""
        ts = time.strftime("%Y%m%d_%H%M%S")
        job_dir = os.path.join(self.job_root, f"{job}_{ts}")
        for sub in ("logs", "outputs"):
            os.makedirs(os.path.join(job_dir, sub), exist_ok=True)
        all_flags = dict(RECOMMENDED_FLAGS)
        all_flags.update(flags or {})
        flag_lines = " \\\n".join(
            f"    --{k} {','.join(map(str, v)) if isinstance(v, (list, tuple)) else v}"
            for k, v in all_flags.items())
        env_exports = "\n".join(f"export {k}={v}"
                                for k, v in self.env.items())
        script = RUN_TEMPLATE.format(
            repo_root=os.path.abspath(self.repo_root), dataset=dataset,
            job=job, out_dir=os.path.join(os.path.abspath(job_dir),
                                          "outputs"),
            flag_lines=flag_lines, env_exports=env_exports)
        if slurm_nodes:
            header, rest = script.split("\n", 1)
            script = header + "\n" + SLURM_HEADER.format(
                job=job, nodes=slurm_nodes,
                log_dir=os.path.join(os.path.abspath(job_dir), "logs")
            ) + rest
        run_sh = os.path.join(job_dir, "run.sh")
        with open(run_sh, "w") as f:
            f.write(script)
        os.chmod(run_sh, os.stat(run_sh).st_mode | stat.S_IEXEC)
        return job_dir

    def run_local(self, job_dir: str) -> int:
        log = os.path.join(job_dir, "logs", "local.out")
        with open(log, "w") as f:
            return subprocess.call(["bash", os.path.join(job_dir, "run.sh")],
                                   stdout=f, stderr=subprocess.STDOUT)

    def submit_slurm(self, job_dir: str) -> str:
        out = subprocess.run(["sbatch", os.path.join(job_dir, "run.sh")],
                             capture_output=True, text=True, check=True)
        return out.stdout.strip()

    def wait_slurm(self, submit_output: str, poll_s: float = 10.0,
                   timeout_s: Optional[float] = None,
                   _poll_cmd=None) -> bool:
        """Poll squeue until the submitted job leaves the queue, as the
        reference launcher waits (exp_driver.py:209-221).
        ``submit_output`` is submit_slurm's return ("Submitted batch job
        <id>"). True when the job finished, False on timeout.
        ``_poll_cmd(job_id) -> still queued`` replaces squeue in tests."""
        job_id = submit_output.strip().split()[-1]

        def squeue_has(jid: str) -> bool:
            out = subprocess.run(["squeue", "-h", "-j", jid],
                                 capture_output=True, text=True)
            return bool(out.stdout.strip())

        poll = _poll_cmd or squeue_has
        t0 = time.monotonic()
        while poll(job_id):
            if timeout_s is not None and time.monotonic() - t0 > timeout_s:
                return False
            time.sleep(poll_s)
        return True

    def submit_and_wait(self, job_dir: str, poll_s: float = 10.0,
                        timeout_s: Optional[float] = None) -> bool:
        return self.wait_slurm(self.submit_slurm(job_dir), poll_s,
                               timeout_s)
