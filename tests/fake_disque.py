"""A disque stand-in for the queue suites: ``fake_servers.FakeRedis`` (its
``ADDJOB``/``GETJOB`` queue) that also acknowledges jobs.

A disque client takes a job with ``GETJOB`` and then confirms it with
``ACKJOB <job-id>...``, which disque answers with the number of jobs it
acknowledged.  ``FakeRedis`` answers ``ACKJOB`` with ``-ERR unknown
command``, so every dequeue of ``suites/disque.py``'s client fails after
its ``GETJOB`` has already taken the job.  ``FakeDisque`` answers each
``ACKJOB`` with the count of its ids and passes every other command to
``FakeRedis``'s handler unchanged.  Stdlib only, like ``fake_servers``.
"""

from __future__ import annotations

from fake_servers import FakeRedis, _RespHandler


class _DisqueHandler(_RespHandler):
    def _read_command(self):
        while True:
            cmd = super()._read_command()
            if cmd is None or cmd[0].upper() != "ACKJOB":
                return cmd
            self.wfile.write(b":%d\r\n" % (len(cmd) - 1))


class FakeDisque(FakeRedis):
    handler_class = _DisqueHandler
