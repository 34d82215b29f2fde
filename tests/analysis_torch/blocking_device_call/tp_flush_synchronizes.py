"""TP: the scheduler flush waits for the card, on the device and on the
event it just recorded, through a helper the flush calls — the
completion lane is the one place that may wait."""

import torch


class Batcher:
    def _flush(self, batch):
        done = self._enqueue(batch)
        self._settle(done)
        self._device_q.put({"batch": batch, "done": done})

    def _enqueue(self, batch):
        done = torch.cuda.Event()
        done.record(self.stream)
        return done

    def _settle(self, done):
        torch.cuda.synchronize()  # BAD
        done.synchronize()  # BAD
        self.stream.synchronize()  # BAD
