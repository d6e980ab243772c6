from repro_torch.comm.collectives import make_int8_compressor
from repro_torch.comm.exchange import (TRANSPORTS, DenseExchange, Exchange,
                                       RaggedExchange, make_exchange)
from repro_torch.comm.round_schedule import (SCHEDULE_METHODS, Round,
                                             RoundPart, RoundSchedule,
                                             best_schedule, bvn_schedule,
                                             greedy_schedule,
                                             rotation_schedule)

__all__ = ["make_int8_compressor", "Exchange", "DenseExchange",
           "RaggedExchange", "make_exchange",
           "TRANSPORTS", "RoundPart", "Round", "RoundSchedule",
           "SCHEDULE_METHODS", "rotation_schedule", "greedy_schedule",
           "bvn_schedule", "best_schedule"]
