"""Message protocol (paper Table 1 / Table 2; port of
``repro/core/messages.py``, numpy only).

Each message is a fixed header + 32-bit data words:

    | type | src | dst | prio | flag | data... |

Types cover the system calls (rcsv-spwn/exit, join-init/free/wait/exit),
task-start and status-beacon.  Messages pack into int32 vectors.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


class MsgType(enum.IntEnum):
    RCSV_SPWN = 0
    RCSV_EXIT = 1
    JOIN_INIT = 2
    JOIN_FREE = 3
    JOIN_WAIT = 4
    JOIN_EXIT = 5
    TASK_START = 6
    STATUS_BEACON = 7


BROADCAST = -1
HEADER_WORDS = 5
MAX_DATA_WORDS = 3
MSG_WORDS = HEADER_WORDS + MAX_DATA_WORDS


@dataclass(frozen=True)
class Message:
    type: MsgType
    src: int
    dst: int                      # BROADCAST for beacons
    prio: int = 0
    flag: int = 0                 # broadcast flag
    data: Sequence[int] = field(default_factory=tuple)

    def pack(self) -> np.ndarray:
        w = np.zeros(MSG_WORDS, np.int32)
        w[:HEADER_WORDS] = (int(self.type), self.src, self.dst, self.prio,
                            self.flag)
        for i, d in enumerate(self.data[:MAX_DATA_WORDS]):
            w[HEADER_WORDS + i] = d
        return w

    @staticmethod
    def unpack(w) -> "Message":
        w = np.asarray(w, np.int32)
        return Message(MsgType(int(w[0])), int(w[1]), int(w[2]), int(w[3]),
                       int(w[4]), tuple(int(x) for x in w[HEADER_WORDS:]))


def beacon(src: int, load: int, prio: int = 0) -> Message:
    return Message(MsgType.STATUS_BEACON, src, BROADCAST, prio, 1, (load,))


def task_start(src: int, dst: int, tcb_addr: int, stack_ptr: int,
               prio: int = 0) -> Message:
    return Message(MsgType.TASK_START, src, dst, prio, 0,
                   (tcb_addr, stack_ptr))


def join_exit(src: int, dst: int, barrier_addr: int) -> Message:
    return Message(MsgType.JOIN_EXIT, src, dst, 0, 0, (barrier_addr,))
