"""python3 -m gtmbench --workload <name> --seed <n> --seconds <s> --trace <0|1>
(gtmbench/run.py). setup_s counts from this module's first statement."""
import time

_T0 = time.perf_counter()

from gtmbench.run import main  # noqa: E402

raise SystemExit(main(t_start=_T0))
