"""Job/task DAG scheduler ("taskdb").

The port's copy of `boundless_tpu/cluster/taskdb.py` (plain Python).

Re-design of the reference scheduler (`prover/crates/taskdb`: Redis Lua
function library, `src/redis_backend.rs:18-618`; and the Postgres gen,
`bento/crates/taskdb/migrations/1_taskdb.sql`). Same semantics:

  * streams: (worker_type, priority) work queues with per-user fair-share
    scheduling (reference `reserved`/`be_mult`, `1_taskdb.sql:24-48`):
    users under their reserved concurrent share are claimed first, spare
    capacity splits by best-effort weight (`set_user_quota`)
  * jobs own a DAG of tasks; task states Pending → Ready → Running →
    Done/Failed (`src/lib.rs:87-95`)
  * dependency counts decremented atomically on completion; a task whose
    last dependency completes becomes Ready
  * claims are atomic (single-writer section), lease-based: a Running task
    whose lease expires is requeued by `requeue_expired` (timeout-based
    worker-death recovery, SURVEY.md §5.3)
  * retries with per-task max_retries; errors truncated to 1 KB
  * `find_stuck_pending` surfaces dep-count inconsistencies (§5.2 tripwire)

Two backends, same API: `MemoryBackend` (threading.Lock critical sections —
the in-process stand-in for Redis's single-threaded Lua atomicity) and
`SqliteBackend` (durable, cross-process; BEGIN IMMEDIATE plays the role of
`FOR UPDATE SKIP LOCKED`).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import sqlite3
import threading
import time
import uuid
from typing import Optional


class TaskState(str, enum.Enum):
    PENDING = "pending"
    READY = "ready"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"


class Priority(int, enum.Enum):
    LOW = 0
    MEDIUM = 1
    HIGH = 2


MAX_ERROR_LEN = 1024


@dataclasses.dataclass
class Task:
    job_id: str
    task_id: str
    stream: str  # worker type: exec/prove/join/coproc/snark/aux
    definition: dict
    prereqs: list
    state: TaskState = TaskState.PENDING
    waiting_on: int = 0
    retries: int = 0
    max_retries: int = 3
    timeout_secs: float = 3600.0
    lease_deadline: float = 0.0
    priority: int = Priority.MEDIUM
    output: Optional[dict] = None
    error: Optional[str] = None
    created_at: float = 0.0
    started_at: float = 0.0
    updated_at: float = 0.0


class JobState(str, enum.Enum):
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"


class MemoryBackend:
    """In-process taskdb with Redis-Lua-style atomic sections."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.tasks: dict = {}  # (job, task) -> Task
        self.jobs: dict = {}  # job -> dict(state, user, error)
        self.ready: dict = {}  # stream -> list of (priority-neg, seq, key)
        self.quotas: dict = {}  # user -> (reserved, be_mult)
        self._seq = 0

    # -- per-user fair share (reference `reserved`/`be_mult` stream
    #    columns, bento/crates/taskdb/migrations/1_taskdb.sql:24-48) ------
    def set_user_quota(self, user: str, reserved: int = 0,
                       be_mult: float = 1.0):
        """reserved: guaranteed concurrent tasks per stream; be_mult:
        best-effort weight for capacity beyond everyone's reserve."""
        with self._cond:
            self.quotas[user] = (int(reserved), float(be_mult))

    def _running_by_user(self, stream: str) -> dict:
        out: dict = {}
        for t in self.tasks.values():
            if t.stream == stream and t.state == TaskState.RUNNING:
                u = self.jobs.get(t.job_id, {}).get("user", "default")
                out[u] = out.get(u, 0) + 1
        return out

    def _select_fair(self, stream: str, q: list) -> int:
        """Index into the (priority-sorted) ready list honoring quotas.

        Users under their reserved share win (most-underserved first);
        past the reserves, pick the user with the lowest
        running/be_mult ratio. Single-user queues keep strict
        (priority, fifo) order — identical to the quota-free scheduler.
        """
        users_ready: dict = {}
        for idx, (_, _, key) in enumerate(q):
            u = self.jobs.get(key[0], {}).get("user", "default")
            users_ready.setdefault(u, idx)
        if len(users_ready) == 1:
            return next(iter(users_ready.values()))
        running = self._running_by_user(stream)

        def quota(u):
            return self.quotas.get(u, (0, 1.0))

        under = [u for u in users_ready
                 if running.get(u, 0) < quota(u)[0]]
        if under:
            pick = min(under, key=lambda u: (
                running.get(u, 0) / max(quota(u)[0], 1), users_ready[u]))
        else:
            pick = min(users_ready, key=lambda u: (
                running.get(u, 0) / max(quota(u)[1], 1e-9),
                users_ready[u]))
        return users_ready[pick]

    # -- job/task creation -----------------------------------------------
    def create_job(self, stream: str, definition: dict, user: str = "default",
                   priority: int = Priority.MEDIUM, max_retries: int = 3,
                   timeout_secs: float = 3600.0) -> str:
        """Create a job with its 'init' task (reference create_job)."""
        job_id = str(uuid.uuid4())
        with self._cond:
            self.jobs[job_id] = dict(state=JobState.RUNNING, user=user,
                                     error=None, unresolved=1)
            self._insert_task(Task(job_id=job_id, task_id="init",
                                   stream=stream, definition=definition,
                                   prereqs=[], priority=priority,
                                   max_retries=max_retries,
                                   timeout_secs=timeout_secs))
            self._cond.notify_all()
        return job_id

    def create_task(self, job_id: str, task_id: str, stream: str,
                    definition: dict, prereqs: list,
                    priority: int = Priority.MEDIUM, max_retries: int = 3,
                    timeout_secs: float = 3600.0):
        with self._cond:
            if (job_id, task_id) in self.tasks:
                return  # idempotent: exec-task retries re-emit the plan
            job = self.jobs[job_id]
            assert job["state"] == JobState.RUNNING
            job["unresolved"] += 1
            self._insert_task(Task(job_id=job_id, task_id=task_id,
                                   stream=stream, definition=definition,
                                   prereqs=list(prereqs), priority=priority,
                                   max_retries=max_retries,
                                   timeout_secs=timeout_secs))
            self._cond.notify_all()

    def _insert_task(self, t: Task):
        t.created_at = t.updated_at = time.time()
        waiting = 0
        for p in t.prereqs:
            dep = self.tasks.get((t.job_id, p))
            if dep is None or dep.state not in (TaskState.DONE,):
                waiting += 1
        t.waiting_on = waiting
        t.state = TaskState.PENDING if waiting else TaskState.READY
        self.tasks[(t.job_id, t.task_id)] = t
        if t.state == TaskState.READY:
            self._push_ready(t)

    def _push_ready(self, t: Task):
        self._seq += 1
        self.ready.setdefault(t.stream, []).append((-int(t.priority), self._seq,
                                                    (t.job_id, t.task_id)))
        self.ready[t.stream].sort()

    # -- claiming ---------------------------------------------------------
    def request_work(self, stream: str, worker_id: str = "",
                     timeout: float = 0.0) -> Optional[Task]:
        deadline = time.time() + timeout
        with self._cond:
            while True:
                q = self.ready.get(stream) or []
                if q:
                    _, _, key = q.pop(self._select_fair(stream, q))
                    t = self.tasks[key]
                    t.state = TaskState.RUNNING
                    t.started_at = t.started_at or time.time()
                    t.updated_at = time.time()
                    t.lease_deadline = time.time() + t.timeout_secs
                    return t
                remaining = deadline - time.time()
                if remaining <= 0:
                    return None
                self._cond.wait(min(remaining, 0.05))

    # -- completion -------------------------------------------------------
    def update_task_done(self, job_id: str, task_id: str, output: dict):
        with self._cond:
            t = self.tasks[(job_id, task_id)]
            if t.state != TaskState.RUNNING:
                return  # stale worker; task was requeued and re-claimed
            t.state = TaskState.DONE
            t.output = output
            t.updated_at = time.time()
            job = self.jobs[job_id]
            job["unresolved"] -= 1
            # decrement dependents
            for key, dep in self.tasks.items():
                if key[0] == job_id and task_id in dep.prereqs and \
                        dep.state == TaskState.PENDING:
                    dep.waiting_on -= 1
                    if dep.waiting_on == 0:
                        dep.state = TaskState.READY
                        self._push_ready(dep)
            if job["unresolved"] == 0:
                job["state"] = JobState.DONE
            self._cond.notify_all()

    def update_task_failed(self, job_id: str, task_id: str, error: str):
        """Hard-fail: fails the whole job (reference update_task_failed)."""
        with self._cond:
            t = self.tasks[(job_id, task_id)]
            t.state = TaskState.FAILED
            t.error = (error or "")[:MAX_ERROR_LEN]
            t.updated_at = time.time()
            job = self.jobs[job_id]
            job["state"] = JobState.FAILED
            job["error"] = t.error
            self._cond.notify_all()

    def update_task_retry(self, job_id: str, task_id: str, error: str) -> bool:
        """Retry bookkeeping; returns False when retries are exhausted."""
        with self._cond:
            t = self.tasks[(job_id, task_id)]
            t.retries += 1
            t.updated_at = time.time()
            if t.retries > t.max_retries:
                pass
            else:
                t.state = TaskState.READY
                t.error = (error or "")[:MAX_ERROR_LEN]
                self._push_ready(t)
                self._cond.notify_all()
                return True
        self.update_task_failed(job_id, task_id,
                                f"max retries exceeded: {error}")
        return False

    # -- maintenance crons (reference lib.rs:803-866) ----------------------
    def requeue_expired(self) -> int:
        now = time.time()
        n = 0
        with self._cond:
            for t in self.tasks.values():
                if t.state == TaskState.RUNNING and t.lease_deadline < now:
                    t.state = TaskState.READY
                    t.retries += 1
                    self._push_ready(t)
                    n += 1
            if n:
                self._cond.notify_all()
        return n

    def find_stuck_pending(self) -> list:
        out = []
        with self._cond:
            for key, t in self.tasks.items():
                if t.state != TaskState.PENDING:
                    continue
                if all(self.tasks.get((t.job_id, p)) is not None and
                       self.tasks[(t.job_id, p)].state == TaskState.DONE
                       for p in t.prereqs):
                    out.append(key)
        return out

    def fix_stuck_pending(self) -> int:
        stuck = self.find_stuck_pending()
        with self._cond:
            for key in stuck:
                t = self.tasks[key]
                t.state = TaskState.READY
                t.waiting_on = 0
                self._push_ready(t)
            if stuck:
                self._cond.notify_all()
        return len(stuck)

    # -- queries ----------------------------------------------------------
    def job_state(self, job_id: str) -> dict:
        with self._lock:
            j = self.jobs[job_id]
            return dict(state=j["state"], error=j.get("error"),
                        unresolved=j["unresolved"], user=j.get("user"))

    def job_user(self, job_id: str) -> str:
        with self._lock:
            return self.jobs[job_id]["user"]

    def task_output(self, job_id: str, task_id: str):
        with self._lock:
            return self.tasks[(job_id, task_id)].output

    def count_task_states(self) -> dict:
        with self._lock:
            out = {}
            for t in self.tasks.values():
                key = (t.stream, t.state.value)
                out[key] = out.get(key, 0) + 1
            return out

    def delete_job(self, job_id: str):
        with self._cond:
            self.jobs.pop(job_id, None)
            for key in [k for k in self.tasks if k[0] == job_id]:
                del self.tasks[key]
            for q in self.ready.values():
                q[:] = [e for e in q if e[2][0] != job_id]


class SqliteBackend:
    """Durable taskdb over sqlite (cross-process; broker-side state).

    Mirrors the Postgres-gen schema (`bento/crates/taskdb/migrations/
    1_taskdb.sql:24-117`): jobs, tasks, task_deps folded into a deps JSON.
    """

    SCHEMA = """
    CREATE TABLE IF NOT EXISTS jobs (
        job_id TEXT PRIMARY KEY, state TEXT, user TEXT, error TEXT,
        unresolved INTEGER
    );
    CREATE TABLE IF NOT EXISTS tasks (
        job_id TEXT, task_id TEXT, stream TEXT, definition TEXT,
        prereqs TEXT, state TEXT, waiting_on INTEGER, retries INTEGER,
        max_retries INTEGER, timeout_secs REAL, lease_deadline REAL,
        priority INTEGER, output TEXT, error TEXT,
        created_at REAL, started_at REAL, updated_at REAL,
        PRIMARY KEY (job_id, task_id)
    );
    CREATE INDEX IF NOT EXISTS idx_ready ON tasks(stream, state, priority);
    """

    def __init__(self, path: str = ":memory:"):
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.executescript(self.SCHEMA)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS user_quotas ("
            "user TEXT PRIMARY KEY, reserved INTEGER, be_mult REAL)")
        self._lock = threading.Lock()

    def _tx(self):
        return self._db

    # -- per-user fair share (reference 1_taskdb.sql:24-48) ---------------
    def set_user_quota(self, user: str, reserved: int = 0,
                       be_mult: float = 1.0):
        with self._lock, self._db:
            self._db.execute(
                "INSERT INTO user_quotas VALUES (?,?,?) "
                "ON CONFLICT(user) DO UPDATE SET reserved=?, be_mult=?",
                (user, int(reserved), float(be_mult), int(reserved),
                 float(be_mult)))

    def _fair_user(self, stream: str):
        """The user whose head-of-queue task should be claimed, or None."""
        cands = self._db.execute(
            "SELECT j.user, MAX(t.priority), MIN(t.created_at) "
            "FROM tasks t JOIN jobs j ON j.job_id = t.job_id "
            "WHERE t.stream=? AND t.state='ready' GROUP BY j.user",
            (stream,)).fetchall()
        if not cands:
            return None
        if len(cands) == 1:
            return cands[0][0]
        running = dict(self._db.execute(
            "SELECT j.user, COUNT(*) FROM tasks t JOIN jobs j "
            "ON j.job_id = t.job_id WHERE t.stream=? AND t.state='running' "
            "GROUP BY j.user", (stream,)).fetchall())
        quotas = dict((u, (r, b)) for u, r, b in self._db.execute(
            "SELECT user, reserved, be_mult FROM user_quotas").fetchall())

        def quota(u):
            return quotas.get(u, (0, 1.0))

        order = {u: i for i, (u, _, _) in enumerate(cands)}
        users = [u for u, _, _ in cands]
        under = [u for u in users if running.get(u, 0) < quota(u)[0]]
        if under:
            return min(under, key=lambda u: (
                running.get(u, 0) / max(quota(u)[0], 1), order[u]))
        return min(users, key=lambda u: (
            running.get(u, 0) / max(quota(u)[1], 1e-9), order[u]))

    def create_job(self, stream, definition, user="default",
                   priority=Priority.MEDIUM, max_retries=3,
                   timeout_secs=3600.0) -> str:
        job_id = str(uuid.uuid4())
        now = time.time()
        with self._lock, self._db:
            self._db.execute(
                "INSERT INTO jobs VALUES (?, 'running', ?, NULL, 1)",
                (job_id, user))
            self._db.execute(
                "INSERT INTO tasks VALUES (?,?,?,?,?,?,0,0,?,?,0,?,NULL,NULL,?,0,?)",
                (job_id, "init", stream, json.dumps(definition), "[]",
                 TaskState.READY.value, max_retries, timeout_secs,
                 int(priority), now, now))
        return job_id

    def create_task(self, job_id, task_id, stream, definition, prereqs,
                    priority=Priority.MEDIUM, max_retries=3,
                    timeout_secs=3600.0):
        now = time.time()
        with self._lock, self._db:
            if self._db.execute(
                    "SELECT 1 FROM tasks WHERE job_id=? AND task_id=?",
                    (job_id, task_id)).fetchone():
                return  # idempotent: exec-task retries re-emit the plan
            rows = self._db.execute(
                "SELECT task_id FROM tasks WHERE job_id=? AND state='done' "
                "AND task_id IN (%s)" % ",".join("?" * len(prereqs)),
                [job_id] + list(prereqs)).fetchall() if prereqs else []
            waiting = len(prereqs) - len(rows)
            state = TaskState.PENDING if waiting else TaskState.READY
            self._db.execute(
                "UPDATE jobs SET unresolved = unresolved + 1 WHERE job_id=?",
                (job_id,))
            self._db.execute(
                "INSERT INTO tasks VALUES (?,?,?,?,?,?,?,0,?,?,0,?,NULL,NULL,?,0,?)",
                (job_id, task_id, stream, json.dumps(definition),
                 json.dumps(list(prereqs)), state.value, waiting,
                 max_retries, timeout_secs, int(priority), now, now))

    def request_work(self, stream, worker_id="", timeout=0.0):
        deadline = time.time() + timeout
        while True:
            with self._lock, self._db:
                user = self._fair_user(stream)
                row = self._db.execute(
                    "SELECT t.job_id, t.task_id, t.definition, t.prereqs, "
                    "t.retries, t.max_retries, t.timeout_secs, t.priority, "
                    "t.created_at FROM tasks t JOIN jobs j ON "
                    "j.job_id = t.job_id WHERE t.stream=? AND "
                    "t.state='ready' AND j.user=? "
                    "ORDER BY t.priority DESC, t.created_at LIMIT 1",
                    (stream, user)).fetchone() if user is not None else None
                if row:
                    now = time.time()
                    self._db.execute(
                        "UPDATE tasks SET state='running', started_at="
                        "CASE WHEN started_at=0 THEN ? ELSE started_at END, "
                        "updated_at=?, lease_deadline=? "
                        "WHERE job_id=? AND task_id=?",
                        (now, now, now + row[6], row[0], row[1]))
                    return Task(job_id=row[0], task_id=row[1], stream=stream,
                                definition=json.loads(row[2]),
                                prereqs=json.loads(row[3]),
                                state=TaskState.RUNNING, retries=row[4],
                                max_retries=row[5], timeout_secs=row[6],
                                priority=row[7])
            if time.time() >= deadline:
                return None
            time.sleep(0.02)

    def update_task_done(self, job_id, task_id, output):
        now = time.time()
        with self._lock, self._db:
            cur = self._db.execute(
                "UPDATE tasks SET state='done', output=?, updated_at=? "
                "WHERE job_id=? AND task_id=? AND state='running'",
                (json.dumps(output), now, job_id, task_id))
            if cur.rowcount == 0:
                return
            self._db.execute(
                "UPDATE jobs SET unresolved = unresolved - 1 WHERE job_id=?",
                (job_id,))
            # decrement dependents
            for dep_id, prereqs in self._db.execute(
                    "SELECT task_id, prereqs FROM tasks WHERE job_id=? AND "
                    "state='pending'", (job_id,)).fetchall():
                if task_id in json.loads(prereqs):
                    self._db.execute(
                        "UPDATE tasks SET waiting_on = waiting_on - 1 "
                        "WHERE job_id=? AND task_id=?", (job_id, dep_id))
            self._db.execute(
                "UPDATE tasks SET state='ready' WHERE job_id=? AND "
                "state='pending' AND waiting_on=0", (job_id,))
            self._db.execute(
                "UPDATE jobs SET state='done' WHERE job_id=? AND unresolved=0",
                (job_id,))

    def update_task_failed(self, job_id, task_id, error):
        error = (error or "")[:MAX_ERROR_LEN]
        with self._lock, self._db:
            self._db.execute(
                "UPDATE tasks SET state='failed', error=?, updated_at=? "
                "WHERE job_id=? AND task_id=?",
                (error, time.time(), job_id, task_id))
            self._db.execute(
                "UPDATE jobs SET state='failed', error=? WHERE job_id=?",
                (error, job_id))

    def update_task_retry(self, job_id, task_id, error) -> bool:
        with self._lock, self._db:
            row = self._db.execute(
                "SELECT retries, max_retries FROM tasks WHERE job_id=? AND "
                "task_id=?", (job_id, task_id)).fetchone()
            if row and row[0] + 1 <= row[1]:
                self._db.execute(
                    "UPDATE tasks SET retries=retries+1, state='ready', "
                    "error=? WHERE job_id=? AND task_id=?",
                    ((error or "")[:MAX_ERROR_LEN], job_id, task_id))
                return True
        self.update_task_failed(job_id, task_id,
                                f"max retries exceeded: {error}")
        return False

    def requeue_expired(self) -> int:
        now = time.time()
        with self._lock, self._db:
            cur = self._db.execute(
                "UPDATE tasks SET state='ready', retries=retries+1 "
                "WHERE state='running' AND lease_deadline < ?", (now,))
            return cur.rowcount

    def find_stuck_pending(self):
        out = []
        with self._lock:
            for job_id, task_id, prereqs in self._db.execute(
                    "SELECT job_id, task_id, prereqs FROM tasks WHERE "
                    "state='pending'").fetchall():
                deps = json.loads(prereqs)
                done = [r[0] for r in self._db.execute(
                    "SELECT task_id FROM tasks WHERE job_id=? AND state='done'",
                    (job_id,)).fetchall()]
                if all(d in done for d in deps):
                    out.append((job_id, task_id))
        return out

    def fix_stuck_pending(self) -> int:
        stuck = self.find_stuck_pending()
        with self._lock, self._db:
            for job_id, task_id in stuck:
                self._db.execute(
                    "UPDATE tasks SET state='ready', waiting_on=0 "
                    "WHERE job_id=? AND task_id=?", (job_id, task_id))
        return len(stuck)

    def job_state(self, job_id):
        with self._lock:
            row = self._db.execute(
                "SELECT state, error, unresolved, user FROM jobs "
                "WHERE job_id=?", (job_id,)).fetchone()
            return dict(state=JobState(row[0]), error=row[1],
                        unresolved=row[2], user=row[3])

    def job_user(self, job_id):
        with self._lock:
            row = self._db.execute(
                "SELECT user FROM jobs WHERE job_id=?", (job_id,)).fetchone()
            if row is None:
                raise KeyError(job_id)
            return row[0]

    def task_output(self, job_id, task_id):
        with self._lock:
            row = self._db.execute(
                "SELECT output FROM tasks WHERE job_id=? AND task_id=?",
                (job_id, task_id)).fetchone()
            return json.loads(row[0]) if row and row[0] else None

    def count_task_states(self):
        with self._lock:
            out = {}
            for stream, state, n in self._db.execute(
                    "SELECT stream, state, COUNT(*) FROM tasks "
                    "GROUP BY stream, state").fetchall():
                out[(stream, TaskState(state))] = n
            return out

    def delete_job(self, job_id):
        with self._lock, self._db:
            self._db.execute("DELETE FROM jobs WHERE job_id=?", (job_id,))
            self._db.execute("DELETE FROM tasks WHERE job_id=?", (job_id,))
