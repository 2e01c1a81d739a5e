"""Continuous-batching scheduler.

The single-controller equivalent of the reference router's queue + batcher
(reference: router/src/queue.rs, router/src/batcher.rs): admission control
against the engine's slot/memory budget, FIFO with bounded queue-jumping,
prefill/decode interleaving with a waiting-tokens throttle, per-token
stopping-criteria evaluation, incremental detokenization and stream fan-out.
"""
