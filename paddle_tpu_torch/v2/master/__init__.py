"""``paddle.v2.master`` — the trainer-side client of the elastic master.

Reference: python/paddle/v2/master/client.py — a ctypes client over the Go
master (go/master/service.go) that leases RecordIO-chunk tasks and yields
records; trainers are stateless consumers, which is the elastic-training
design. Here the service is the port's
``paddle_tpu_torch.distributed.master.Master`` (the same task-queue
contract: leases, timeouts, retry limits, snapshots) and this module
provides the reference client surface over its RPC."""

from __future__ import annotations

from ...distributed.master import MasterClient

__all__ = ["client"]


class client:
    """Reference client.py surface: ``set_dataset(paths)`` registers the
    RecordIO files as this pass's chunks, ``next_record()`` returns one
    record (None at pass end), ``request_save_model`` arbitrates which
    trainer saves, ``paddle_start_get_records``/``release`` mirror the
    reference's lifecycle calls."""

    def __init__(self, addr, timeout_sec=3.0, buf_size=0):
        # addr: the master service address ("host:port" or (host, port));
        # the reference takes etcd endpoints for discovery — discovery is
        # out of scope for the in-process service, the address is direct.
        from ...distributed.param_server import parse_endpoint
        self._client = MasterClient(parse_endpoint(addr))
        self._records = iter(())
        del timeout_sec, buf_size  # server-side / C-buffer concerns

    def set_dataset(self, paths):
        self._client.set_dataset(list(paths), chunks_per_task=1)

    def paddle_start_get_records(self, pass_id=0):
        self._records = self._record_stream()

    def _record_stream(self):
        from ...recordio import Scanner
        for task_id, epoch, chunks in self._client.tasks():
            ok = True
            for path in chunks:
                try:
                    scanner = iter(Scanner(path))
                except Exception:
                    ok = False
                    break
                # stream record-by-record (chunks can be multi-GB shards);
                # a mid-chunk read error fails the task AFTER some records
                # were delivered — the master requeues it and redelivery
                # duplicates them, the at-least-once elastic contract
                # (reference Go client taskFailed keeps fetching too; a
                # dead generator here would turn one bad chunk into a
                # silent early pass-end)
                try:
                    for rec in scanner:
                        yield rec
                except Exception:
                    ok = False
                    break
            if ok:
                self._client.finished(task_id, epoch)
            else:
                self._client.failed(task_id, epoch)

    def next_record(self):
        """One record, or None when the pass is exhausted (the reference
        returns size -2 at pass end)."""
        return next(self._records, None)

    def request_save_model(self, trainer_id, block_ms):
        return self._client.request_save_model(trainer_id, block_ms)

    def release(self):
        self._client.close()
        self._client = None
