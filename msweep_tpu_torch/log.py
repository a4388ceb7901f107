"""Timestamped, verbosity-gated logging to stderr.

Equivalent of the reference's ``mSWEEP::Log`` (include/mSWEEP_log.hpp:43-59):
every message is prefixed with a ctime timestamp when verbose, and
``flush()`` reports the total elapsed time (include/mSWEEP_log.hpp:27-36).
In multi-process (torch.distributed) runs only process 0 logs, mirroring the
reference's MPI-era root-only logging (include/log.hpp:41-46).
"""

from __future__ import annotations

import sys
import time


class Log:
    def __init__(self, verbose: bool = False, stream=None, process_index: int = 0):
        self.verbose = verbose and process_index == 0
        self.stream = stream if stream is not None else sys.stderr
        self._start = time.time()

    def __call__(self, msg: str) -> None:
        if self.verbose:
            stamp = time.ctime()
            self.stream.write(f"{stamp}: {msg}\n")
            self.stream.flush()

    # Alias matching reference Log::status (prints regardless of verbosity).
    def status(self, msg: str) -> None:
        self.stream.write(msg + "\n")
        self.stream.flush()

    def flush(self) -> None:
        if self.verbose:
            elapsed = time.time() - self._start
            self.stream.write(f"{time.ctime()}: elapsed_time: {elapsed:.2f}s\n")
            self.stream.flush()
