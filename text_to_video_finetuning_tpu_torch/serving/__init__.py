"""Serving (port of text_to_video_finetuning_tpu/serving): one warm pipeline
resident on the card behind an HTTP server (`t2v-serve-torch`), with
requests of one signature coalesced into one batched `generate`."""

from .server import (BatchingWorker, GenerationRequest, ServerOverloaded,
                     T2VServer, request_batch_key)

__all__ = ["BatchingWorker", "GenerationRequest", "ServerOverloaded",
           "T2VServer", "request_batch_key"]
