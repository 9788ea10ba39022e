"""Milliseconds a traced step that the main thread was inside the program's
``train.zero_grad``, ``train.draw``, ``train.forward`` or
``train.optimizer`` spans and not running on a CPU: each span's wall time
less the thread's CPU time over it (waiting for the interpreter lock or
the scheduler, or blocked in a CUDA call), in the device-only pass
(``perfbench/spans.py``). ``train.backward`` is left out: there autograd's
own thread works while the main thread waits."""

from perfbench import spans

PHASES = {"bndm.train.zero_grad", "bndm.train.draw", "bndm.train.forward",
          "bndm.train.optimizer"}


def read(rec):
    return spans.per_step_ms(rec, PHASES, off_cpu=True)
