"""Launchers of the port: ``train`` (CTR training, serial or pipelined),
``serve`` (LM prefill + decode), the ``--tuned-host`` profile of
``hostenv`` and the shared ``--emb-shards`` / spec plumbing of ``shards``."""
