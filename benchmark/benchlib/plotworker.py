"""
A plot worker that records render jobs instead of running them, for a
report entry: the submit / drain contract of the program's plot workers
(`audio_analysis_tpu_torch.parallel`), every job kept and none drawn, so a
report runs where matplotlib is absent (the card's host) and its figures'
arrays can be judged. A frozen copy of the port's test helper of the same
name, kept here so that no change to the tests moves the yardstick.
"""

from __future__ import annotations


class RecordingPlotWorker:
    def __init__(self):
        self.jobs = []

    def submit(self, job, label=None):
        self.jobs.append(job)

    def drain(self):
        pass

    def drain_collect(self):
        return []

    def timings_by_kind(self):
        return {}

    def close(self):
        pass
