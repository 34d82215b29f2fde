"""TP: the card scorer's submit path pulls values back to the host —
each copy waits for the card, so the dispatch stream never runs ahead."""

import torch


class Scorer:
    def submit(self, rows, n):
        with torch.cuda.stream(self.stream):
            best = self._best(*rows.tensors[:4])
            top = best[0].max().item()  # BAD
            rows.out.copy_(best.cpu())  # BAD
            self.seen.extend(best[0].tolist())  # BAD
            done = torch.cuda.Event()
            done.record(self.stream)
        return done, top
