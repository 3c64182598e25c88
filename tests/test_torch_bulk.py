"""The port's bulk layer (``karanta_tpu_torch/bulk/``: the SQLite job store,
least-loaded routing, the dispatcher's retries, the CLI with resume): the
six cases of tests/test_bulk.py against ``tests/fake_server.py``, and the
port's bulk CLI against the port's server beside the JAX bulk CLI against
the JAX server (tiny, float32, the same weights and request files): the
same completion texts and status counts.
"""

import asyncio
import json
import os
import socket

from karanta_tpu_torch.bulk.database import JobDatabase
from karanta_tpu_torch.bulk.dispatcher import BulkDispatcher, ServerRouter
from karanta_tpu_torch.bulk.main import amain, parse_args
from tests.fake_server import FakeOpenAIServer


def _requests(n=5):
    return [{"custom_id": f"req-{i}",
             "messages": [{"role": "user", "content": f"page {i}"}],
             "max_tokens": 16} for i in range(n)]


def test_job_database_create_and_progress(tmp_path):
    db = JobDatabase(str(tmp_path / "jobs.db"))
    job_id = db.create_job(_requests(3))
    job = db.get_job(job_id)
    assert job["total_tasks"] == 3
    assert job["progress"] == 0.0
    tasks = db.get_pending_tasks(job_id)
    assert len(tasks) == 3
    db.update_task_status(tasks[0]["task_id"], "processing")
    db.update_task_status(tasks[0]["task_id"], "completed",
                          result_path="/r/0.json")
    job = db.get_job(job_id)
    assert job["status_counts"]["completed"] == 1
    assert 0 < job["progress"] < 1


def test_job_database_failed_retry_eligibility(tmp_path):
    db = JobDatabase(str(tmp_path / "jobs.db"))
    job_id = db.create_job(_requests(1))
    (task,) = db.get_pending_tasks(job_id)
    for _ in range(3):
        db.update_task_status(task["task_id"], "processing")
        db.update_task_status(task["task_id"], "failed", error="x")
    assert db.get_pending_tasks(job_id, max_retries=10)
    assert not db.get_pending_tasks(job_id, max_retries=3)


def test_job_database_analytics(tmp_path):
    db = JobDatabase(str(tmp_path / "jobs.db"))
    job_id = db.create_job(_requests(2))
    for task in db.get_pending_tasks(job_id):
        db.update_task_status(task["task_id"], "processing")
        db.update_task_status(task["task_id"], "completed")
    stats = db.get_job_analytics(job_id)
    assert stats["n"] == 2
    assert stats["avg_ms"] is not None


def test_dispatcher_processes_all_tasks(tmp_path):
    server = FakeOpenAIServer()

    async def run():
        await server.start()
        try:
            db = JobDatabase(str(tmp_path / "jobs.db"))
            job_id = db.create_job(_requests(6))
            router = ServerRouter([server.url.replace("/v1", "")])
            dispatcher = BulkDispatcher(db, router,
                                        str(tmp_path / "results"),
                                        concurrency=3)
            return await dispatcher.run_job(job_id)
        finally:
            await server.stop()

    job = asyncio.run(run())
    assert job["status_counts"].get("completed") == 6
    results = os.listdir(tmp_path / "results")
    assert len(results) == 6
    with open(tmp_path / "results" / sorted(results)[0]) as f:
        payload = json.load(f)
    assert payload["response"]["choices"][0]["message"]["content"]


def test_dispatcher_retries_transient_failures(tmp_path):
    server = FakeOpenAIServer()
    fail_once = set()

    def responder(request, idx):
        key = request["messages"][0]["content"]
        if key not in fail_once:
            fail_once.add(key)
            return 500, b"transient"
        return 200, server.completion([server.page_json("ok")])

    server.responder = responder

    async def run():
        await server.start()
        try:
            db = JobDatabase(str(tmp_path / "jobs.db"))
            job_id = db.create_job(_requests(4))
            router = ServerRouter([server.url.replace("/v1", "")])
            dispatcher = BulkDispatcher(db, router,
                                        str(tmp_path / "results"),
                                        concurrency=2, max_retries=5)
            return await dispatcher.run_job(job_id)
        finally:
            await server.stop()

    job = asyncio.run(run())
    assert job["status_counts"].get("completed") == 4


def _write_requests(reqs_dir, n=3):
    reqs_dir.mkdir()
    with open(reqs_dir / "batch0.jsonl", "w") as f:
        for req in _requests(n):
            f.write(json.dumps(req) + "\n")
    # the OpenAI batch format
    with open(reqs_dir / "batch1.jsonl", "w") as f:
        f.write(json.dumps({
            "custom_id": "b1-0",
            "body": {"messages": [{"role": "user", "content": "x"}],
                     "max_tokens": 8}}) + "\n")


def test_bulk_cli_end_to_end_with_resume(tmp_path):
    reqs_dir = tmp_path / "reqs"
    _write_requests(reqs_dir)
    server = FakeOpenAIServer()

    async def run():
        port = await server.start()
        try:
            args = parse_args([
                "--input", str(reqs_dir), "--output", str(tmp_path / "out"),
                "--servers", f"http://127.0.0.1:{port}"])
            jobs = await amain(args)
            calls1 = len(server.calls)
            jobs2 = await amain(args)  # resume: every result exists
            return jobs, calls1, len(server.calls), jobs2
        finally:
            await server.stop()

    jobs, calls1, calls2, jobs2 = asyncio.run(run())
    assert len(jobs) == 2
    assert jobs[0]["status_counts"].get("completed") == 3
    assert calls1 == 4
    assert calls2 == 4  # no re-processing on resume
    assert jobs2[0]["status_counts"].get("completed") == 3
    assert (tmp_path / "out" / "batch0" / "job_id.txt").exists()


def _dead_url() -> str:
    """A localhost URL on which nothing listens."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}"


def _results(out_dir) -> dict:
    """{custom_id: (content, finish_reason, usage, server)} of a bulk
    output directory."""
    found = {}
    for root, _, files in os.walk(out_dir):
        for name in files:
            if name.endswith(".json"):
                with open(os.path.join(root, name)) as f:
                    r = json.load(f)
                choice = r["response"]["choices"][0]
                found[r["custom_id"]] = (choice["message"]["content"],
                                         choice["finish_reason"],
                                         r["response"]["usage"], r["server"])
    return found


def test_bulk_cli_on_the_port_server_equals_jax(tmp_path):
    """Each package's bulk CLI over its own server (tiny, float32, the same
    weights) and a dead endpoint: every task completes on the live server,
    with the same completion texts and status counts."""
    from karanta_tpu.bulk.main import amain as j_amain
    from karanta_tpu.bulk.main import parse_args as j_parse_args
    from tests.test_torch_server import ENGINE_KW, _server_pair

    reqs_dir = tmp_path / "reqs"
    _write_requests(reqs_dir)
    dead = _dead_url()
    with _server_pair(**ENGINE_KW) as pair:
        runs = {}
        for name, (main, parse) in {"jax": (j_amain, j_parse_args),
                                    "port": (amain, parse_args)}.items():
            live = f"http://127.0.0.1:{pair[name]}"
            args = parse(["--input", str(reqs_dir), "--output",
                          str(tmp_path / name), "--servers", dead, live,
                          "--concurrency", "4"])
            runs[name] = (asyncio.run(main(args)), live)
    (jjobs, jlive), (tjobs, tlive) = runs["jax"], runs["port"]
    assert [j["status_counts"] for j in tjobs] == \
        [j["status_counts"] for j in jjobs] == [{"completed": 3},
                                                {"completed": 1}]
    want, got = _results(tmp_path / "jax"), _results(tmp_path / "port")
    assert set(got) == set(want) == {"req-0", "req-1", "req-2", "b1-0"}
    for cid, (content, finish, usage, server) in got.items():
        assert (content, finish, usage) == want[cid][:3], cid
        assert server == tlive and want[cid][3] == jlive
