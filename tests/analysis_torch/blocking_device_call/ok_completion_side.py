"""OK: the submit path only enqueues and returns the event; the waits
(event.synchronize(), torch.cuda.synchronize(), the host copies) live
on the completion side, which no submit entry reaches."""

import torch


class Batcher:
    def _flush(self, batch):
        done = self.scorer.submit(batch.rows, len(batch))
        self._device_q.put({"batch": batch, "done": done})

    def _complete_group(self, pend):
        pend["done"].synchronize()
        torch.cuda.synchronize()
        best = pend["batch"].rows.out
        top = best.max().item()
        return best.cpu(), best.tolist(), top


class DeviceFuture:
    def result(self):
        for done in self._events:
            done.synchronize()
        return [slot.out.tolist() for slot in self._slots]
