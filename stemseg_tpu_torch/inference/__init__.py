"""Streaming DAVIS inference: engine, clustering, chainer, writer, CLI."""
