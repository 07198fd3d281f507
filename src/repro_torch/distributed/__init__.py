"""Distributed training of the port: the paper's scheduling
policies over real training (``hetsched``) and the lossy worker->master
gradient hop (``compression``)."""
from . import compression, hetsched
from .compression import Int8Compressor, TopKCompressor
from .hetsched import POLICIES, HetTrainer, StepReport

__all__ = ["compression", "hetsched", "Int8Compressor", "TopKCompressor",
           "POLICIES", "HetTrainer", "StepReport"]
