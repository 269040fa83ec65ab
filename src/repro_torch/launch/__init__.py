"""Launchers of the port: ``serve`` (LM prefill + decode) and the shared
``--emb-shards`` / spec plumbing of ``shards``."""
