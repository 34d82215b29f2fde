"""OK: the scorer's ``__call__`` is the synchronous form of submit, the
sanctioned home of the wait (as ``dispatch_chunks`` is for the async
seam); one-shot callers off the pipeline may use it freely."""

import torch


class Scorer:
    def submit(self, rows, n):
        with torch.cuda.stream(self.stream):
            best = self._best(*rows.tensors[:4])
            rows.out.copy_(best.view(-1), non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return done

    def __call__(self, file_bits, n_words, lengths, cc_fp):
        rows = self.host_rows(len(n_words))
        n = rows.fill(file_bits, n_words, lengths, cc_fp)
        done = self.submit(rows, n)
        if done is not None:
            done.synchronize()
        torch.cuda.synchronize()
        top = rows.out.max().item()
        return rows.out.cpu(), rows.out.tolist(), top
