"""One cold process of the port's warm-start plane: ``python
tests/torch_warmstart_child.py SERVICE_DIR`` runs one 2pc-3 job on a
``CheckService(service_dir=SERVICE_DIR, device="cpu")`` (solo, with its
namespace's disk record) and prints one ``WARMSTART-CHILD {json}`` line:
the verdict, the job's ``aot_cache.*`` counters and its compile seconds.
``tests/test_torch_warmstart.py`` runs it twice against one directory."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stateright_tpu_torch.service import CheckService  # noqa: E402

SPAWN = {"frontier_capacity": 16, "table_capacity": 1 << 12, "max_drain_waves": 2}


def main():
    svc = CheckService(service_dir=sys.argv[1], quantum_s=60.0, default_spawn=dict(SPAWN),
                       device="cpu")
    try:
        h = svc.submit(model_name="2pc", model_args={"rm_count": 3},
                       spawn={"attribution": True})
        r = h.result(timeout=300)
    finally:
        svc.close()
    attr = r.get("attribution") or {}
    print("WARMSTART-CHILD " + json.dumps({
        "unique": r["unique"],
        "properties_hold": r["properties_hold"],
        "aot": r.get("aot"),
        "compile_phase_s": attr.get("phases_s", {}).get("compile", 0.0),
        "warm_start": bool(r.get("warm_start")),
    }), flush=True)


if __name__ == "__main__":
    main()
