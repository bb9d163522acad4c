from intrepppid_tpu_torch.serve.coalesce import CoalescingScorer
from intrepppid_tpu_torch.serve.engine import ScoringEngine
from intrepppid_tpu_torch.serve.server import PPIServer

__all__ = ["CoalescingScorer", "ScoringEngine", "PPIServer"]
