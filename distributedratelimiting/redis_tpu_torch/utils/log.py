"""Structured log events.

Mirror of the reference's source-generated ``LoggerMessage`` partials
(``RedisApproximateTokenBucketRateLimiter.Log.cs:9-13``): two error events,
same ids — 1 = could not connect/reach the store, 2 = error executing the
store kernel. Called from the refresh path only, matching the reference's
degraded-mode posture (log and keep serving; SURVEY.md invariant 9).

The chaos plane (cluster breakers, node quarantine) adds two more:
3 = a named cluster node failed a store operation (the event that makes
partitions VISIBLE — the old code swallowed them), 4 = a node's circuit
breaker changed state. Both carry the node index in ``extra`` so log
pipelines can pivot per node.

The membership plane adds 5 = a migration committed or aborted (the
full event dict — moved slots/keys, epochs, handoff window — rides in
``extra``, mirroring ``ClusterBucketStore.migration_log``).

The autonomous control plane adds 6 = the controller decided an action
(split / rebalance / drain / rejoin / shed step — executed, dry-run,
budget-starved, or failed; the full record mirrors
``Controller.actions``).
"""

from __future__ import annotations

import logging

logger = logging.getLogger("distributedratelimiting.redis_tpu_torch")

EVENT_COULD_NOT_CONNECT = 1
EVENT_ERROR_EVALUATING = 2
EVENT_CLUSTER_NODE_ERROR = 3
EVENT_BREAKER_TRANSITION = 4
EVENT_CLUSTER_MIGRATION = 5
EVENT_CONTROLLER_ACTION = 6


def could_not_connect_to_store(exc: BaseException) -> None:
    """Event id 1 — ``Log.CouldNotConnectToRedis``."""
    logger.error(
        "Could not connect to the backing store",
        exc_info=exc,
        extra={"event_id": EVENT_COULD_NOT_CONNECT},
    )


def error_evaluating_kernel(exc: BaseException) -> None:
    """Event id 2 — ``Log.ErrorEvaluatingRedisScript``."""
    logger.error(
        "Error executing store kernel",
        exc_info=exc,
        extra={"event_id": EVENT_ERROR_EVALUATING},
    )


def cluster_node_error(node: int, exc: BaseException) -> None:
    """Event id 3 — a cluster node failed a store operation. Always
    paired with the ``cluster_node_errors`` counter so a partition shows
    up in BOTH the logs and the metrics plane."""
    logger.error(
        "Cluster node %d failed a store operation",
        node,
        exc_info=exc,
        extra={"event_id": EVENT_CLUSTER_NODE_ERROR, "node": node},
    )


def breaker_transition(node: int, old: str, new: str) -> None:
    """Event id 4 — a node's circuit breaker changed state (quarantine
    on ``-> open``, probe on ``-> half_open``, rejoin on ``-> closed``)."""
    logger.warning(
        "Cluster node %d circuit breaker: %s -> %s",
        node, old, new,
        extra={"event_id": EVENT_BREAKER_TRANSITION, "node": node,
               "breaker_old": old, "breaker_new": new},
    )


def cluster_migration(event: dict) -> None:
    """Event id 5 — a membership migration or live config mutation
    committed or aborted. The event dict is the same record
    ``ClusterBucketStore.migration_log`` keeps (migrations: type,
    reason, epochs, moved slots/keys, window times; config mutations:
    kind, old/new operands, version)."""
    if str(event.get("type", "")).startswith("config"):
        logger.warning(
            "Cluster config %s: %s %s -> %s (version %s)",
            event.get("type"), event.get("kind"), event.get("old"),
            event.get("new"), event.get("version"),
            extra={"event_id": EVENT_CLUSTER_MIGRATION,
                   "migration": dict(event)},
        )
        return
    logger.warning(
        "Cluster migration %s: %s -> epoch %s (%s)",
        event.get("type"), event.get("from_epoch"),
        event.get("target_epoch"), event.get("reason"),
        extra={"event_id": EVENT_CLUSTER_MIGRATION,
               "migration": dict(event)},
    )


def controller_action(record: dict) -> None:
    """Event id 6 — the autonomous controller decided an action. The
    record is the same dict ``Controller.actions`` keeps (tick, action,
    target, reason, outcome, actuator extras) — the log pipeline's view
    of every autonomous move, executed or not."""
    logger.warning(
        "Controller %s -> %s (%s): %s",
        record.get("action"), record.get("target"),
        record.get("outcome"), record.get("reason"),
        extra={"event_id": EVENT_CONTROLLER_ACTION,
               "controller": dict(record)},
    )
