// stateright_tpu_torch explorer — minimal vanilla-JS client for the Explorer API:
//   GET  /.status               checker progress + property discoveries
//   GET  /.states/fp1/fp2/...   replay a fingerprint path, list next steps
//   POST /.runtocompletion      unblock the on-demand checker
"use strict";

const state = {
  path: [],        // fingerprints (strings) from an init state
  labels: [],      // action label per path entry
  steps: [],       // next steps at the current state
  selected: 0,
};

const $ = (id) => document.getElementById(id);

// Server strings (state reprs, action labels, property names) are untrusted
// for HTML purposes — escape everything interpolated into innerHTML.
function esc(text) {
  return String(text)
    .replaceAll("&", "&amp;").replaceAll("<", "&lt;").replaceAll(">", "&gt;")
    .replaceAll('"', "&quot;").replaceAll("'", "&#39;");
}

async function getJSON(url, opts) {
  const response = await fetch(url, opts);
  if (!response.ok) throw new Error(`${url}: ${response.status}`);
  return response.json();
}

function badge(status) {
  const symbol = { ok: "✅", witnessed: "✅", violated: "❌", pending: "⏳" }[status] || "·";
  return `<span class="badge ${status}">${symbol}</span>`;
}

async function refreshStatus() {
  try {
    const s = await getJSON("/.status");
    $("status").textContent =
      `states=${s.state_count} unique=${s.unique_state_count} ` +
      `depth=${s.max_depth}${s.done ? " (done)" : ""}`;
    const items = s.properties.map((p) => {
      let extra = "";
      // Discoveries refute "always"/"eventually" (counterexamples) and
      // witness "sometimes" (examples).
      const refutes = p.expectation === "always" || p.expectation === "eventually";
      if (p.discovery) {
        const kind = refutes ? "counterexample" : "example";
        extra = ` <a href="#" class="discovery" data-fps="${esc(p.discovery.fingerprints)}">${kind}</a>`;
      }
      const status = p.discovery ? (refutes ? "violated" : "witnessed") : "pending";
      return `<li>${badge(status)} <b>${esc(p.expectation)}</b> ${esc(p.name)}${extra}</li>`;
    });
    $("properties").innerHTML = items.join("");
    document.querySelectorAll(".discovery").forEach((a) =>
      a.addEventListener("click", (e) => {
        e.preventDefault();
        followFingerprints(a.dataset.fps.split("/"));
      }));
  } catch (err) {
    $("status").textContent = `status error: ${err.message}`;
  }
}

async function refreshSteps() {
  const url = "/.states/" + state.path.join("/");
  const view = await getJSON(url);
  state.steps = view.next_steps;
  state.selected = 0;
  $("current-state").textContent = view.state || "(choose an initial state)";
  renderPath();
  renderSteps();
  $("svg-panel").innerHTML = view.svg || "";
}

function renderPath() {
  $("path").innerHTML = state.labels
    .map((label, i) => `<li data-i="${i}">${esc(label)}</li>`)
    .join("");
  document.querySelectorAll("#path li").forEach((li) =>
    li.addEventListener("click", () => {
      const n = Number(li.dataset.i) + 1;
      state.path = state.path.slice(0, n);
      state.labels = state.labels.slice(0, n);
      refreshSteps();
    }));
}

function renderSteps() {
  $("steps").innerHTML = state.steps
    .map((step, i) => {
      const label = step.action === null ? "(init)" : step.action;
      const props = (step.properties || [])
        .map((p) => badge(p.status))
        .join("");
      const selected = i === state.selected ? " selected" : "";
      return `<li class="step${selected}" data-i="${i}">` +
        `<b>${esc(label)}</b> ${props}<pre>${esc(step.outcome)}</pre></li>`;
    })
    .join("");
  document.querySelectorAll("#steps .step").forEach((li) =>
    li.addEventListener("click", () => takeStep(Number(li.dataset.i))));
}

function takeStep(i) {
  const step = state.steps[i];
  if (!step) return;
  state.path.push(step.fingerprint);
  state.labels.push(step.action === null ? "(init)" : step.action);
  refreshSteps();
}

async function followFingerprints(fps) {
  // Walk a discovery path fingerprint by fingerprint, labeling from the
  // server's step info at each hop.
  state.path = [];
  state.labels = [];
  for (const fp of fps) {
    const view = await getJSON("/.states/" + state.path.join("/"));
    const match = view.next_steps.find((s) => s.fingerprint === fp);
    state.path.push(fp);
    state.labels.push(match ? (match.action === null ? "(init)" : match.action) : fp);
  }
  refreshSteps();
}

document.addEventListener("keydown", (e) => {
  if (e.key === "j") {
    state.selected = Math.min(state.selected + 1, state.steps.length - 1);
    renderSteps();
  } else if (e.key === "k") {
    state.selected = Math.max(state.selected - 1, 0);
    renderSteps();
  } else if (e.key === "Enter") {
    takeStep(state.selected);
  } else if (e.key === "Backspace") {
    state.path.pop();
    state.labels.pop();
    refreshSteps();
  }
});

$("run").addEventListener("click", () =>
  fetch("/.runtocompletion", { method: "POST" }).then(refreshStatus));
$("reset").addEventListener("click", () => {
  state.path = [];
  state.labels = [];
  refreshSteps();
});

// ---- live monitor panel ---------------------------------------------------
// Fed by the monitor endpoints the server mounts next to the Explorer API:
// /events (SSE wave/storage stream) drives the states/s sparkline, /status
// (JSON snapshot) fills depth, hash-set fill, tier bytes, and the ETA band.
// The panel stays hidden when the endpoints are absent (plain static serve).

const monitor = { points: [], max: 120, lastStatusFetch: 0, backend: null };

function fmtNum(n) {
  if (n === null || n === undefined) return "–";
  if (n >= 1e6) return (n / 1e6).toFixed(1) + "M";
  if (n >= 1e3) return (n / 1e3).toFixed(1) + "k";
  return Number(n).toFixed(n >= 10 ? 0 : 1);
}

function fmtSecs(s) {
  if (s === null || s === undefined) return "–";
  if (s < 90) return s.toFixed(0) + "s";
  if (s < 5400) return (s / 60).toFixed(1) + "m";
  return (s / 3600).toFixed(1) + "h";
}

function drawSparkline() {
  const canvas = $("monitor-sparkline");
  const ctx = canvas.getContext("2d");
  ctx.clearRect(0, 0, canvas.width, canvas.height);
  const pts = monitor.points;
  if (pts.length < 2) return;
  const peak = Math.max(...pts, 1e-9);
  ctx.beginPath();
  // Scale x to the points present (short runs fill the canvas); only a
  // full buffer scrolls at the fixed window width.
  const span = Math.max(pts.length - 1, 1);
  pts.forEach((v, i) => {
    const x = (i / span) * canvas.width;
    const y = canvas.height - 2 - (v / peak) * (canvas.height - 6);
    i === 0 ? ctx.moveTo(x, y) : ctx.lineTo(x, y);
  });
  ctx.strokeStyle = "#10394c";
  ctx.lineWidth = 1.5;
  ctx.stroke();
}

function onWaveEvent(d) {
  // Remember the live backend's span-name prefix ("tpu_bfs.drain" ->
  // "tpu_bfs"): the metrics registry is process-global, so a finished
  // earlier run's gauges must not shadow this run's in /status picks.
  if (d.name) monitor.backend = d.name.split(".")[0];
  if (d.ewma_states_per_s !== null && d.ewma_states_per_s !== undefined) {
    monitor.points.push(d.ewma_states_per_s);
    if (monitor.points.length > monitor.max) monitor.points.shift();
    $("mon-rate").textContent = fmtNum(d.ewma_states_per_s);
  }
  if (d.max_depth !== null && d.max_depth !== undefined)
    $("mon-depth").textContent = d.max_depth;
  if (d.occupancy !== null && d.occupancy !== undefined)
    $("mon-fill").textContent = (100 * d.occupancy).toFixed(1) + "%";
  if (d.eta_s_low !== null && d.eta_s_low !== undefined)
    $("mon-eta").textContent =
      fmtSecs(d.eta_s_low) + "–" + fmtSecs(d.eta_s_high);
  drawSparkline();
}

async function refreshMonitorStatus() {
  // Throttled: storage events can arrive several times per wave during
  // heavy spilling, and each full /status fetch is not free.
  const now = Date.now();
  if (now - monitor.lastStatusFetch < 1500) return;
  monitor.lastStatusFetch = now;
  try {
    const s = await getJSON("/status");
    const m = s.metrics || {};
    const pick = (suffix) => {
      // Prefer the backend the SSE stream says is live; fall back to any
      // suffix match (single-backend processes, pre-first-wave polls).
      let fallback = null;
      for (const k of Object.keys(m)) {
        if (!k.endsWith(suffix)) continue;
        if (monitor.backend && k.startsWith(monitor.backend + "."))
          return m[k];
        if (fallback === null) fallback = m[k];
      }
      return fallback;
    };
    const occ = pick(".hashset_occupancy");
    if (occ !== null) $("mon-fill").textContent = (100 * occ).toFixed(1) + "%";
    const l0 = pick(".storage.l0_resident");
    if (l0 !== null) $("mon-l0").textContent = fmtNum(l0) + " fps";
    const hostB = pick(".storage.host_bytes");
    const diskB = pick(".storage.disk_bytes");
    if (hostB !== null || diskB !== null)
      $("mon-tiers").textContent =
        fmtNum(hostB || 0) + "B / " + fmtNum(diskB || 0) + "B";
    // Pipeline attribution (attribution-mode runs only): cumulative
    // device share of wave wall — the utilization row.
    const util = m["monitor.pipeline.utilization"];
    if (util !== null && util !== undefined)
      $("mon-util").textContent = (100 * util).toFixed(1) + "%";
    // Coverage cartography (coverage-mode device runs; host engines
    // always-on): the action-coverage fraction plus the per-action bar
    // view built from the <prefix>.coverage.action_* counters.
    const acov = m["monitor.coverage.action_coverage"];
    if (acov !== null && acov !== undefined)
      $("mon-action-cov").textContent = (100 * acov).toFixed(0) + "%";
    // Swarm runs: the unique-coverage sample (distinct walk
    // fingerprints; "≥" once the fixed-capacity sample table saturated
    // — the estimate is then an honest lower bound).
    const swarmUnique = pick("swarm.unique_sample");
    if (swarmUnique !== null) {
      const sat = m["swarm.sample_saturated"];
      $("mon-swarm").textContent =
        (sat ? "≥" : "") + fmtNum(swarmUnique) + " uniq";
    }
    renderCoverageBars(m);
    const p = s.progress || {};
    if (p.max_depth !== null && p.max_depth !== undefined)
      $("mon-depth").textContent = p.max_depth;
    if (p.eta_s_low !== null && p.eta_s_low !== undefined)
      $("mon-eta").textContent =
        fmtSecs(p.eta_s_low) + "–" + fmtSecs(p.eta_s_high);
  } catch (err) {
    // monitor endpoints absent or mid-teardown; leave the panel as-is
  }
}

// ---- coverage panel -------------------------------------------------------
// Per-action fired/fresh bars from the registry snapshot in /status:
// `<prefix>.coverage.action_fired.<label>` counters (the live backend's
// prefix preferred, like every other pick). Dead actions (fired == 0)
// render flagged — the vacuity signal the panel exists for.

function renderCoverageBars(m) {
  const fired = {};
  const fresh = {};
  for (const k of Object.keys(m)) {
    const fi = k.indexOf(".coverage.action_fired.");
    const fr = k.indexOf(".coverage.action_fresh.");
    const backendOk = !monitor.backend || k.startsWith(monitor.backend + ".");
    if (fi >= 0 && backendOk)
      fired[k.slice(fi + ".coverage.action_fired.".length)] = m[k];
    if (fr >= 0 && backendOk)
      fresh[k.slice(fr + ".coverage.action_fresh.".length)] = m[k];
  }
  const labels = Object.keys(fired).sort();
  if (!labels.length) return;
  $("coverage-panel").classList.remove("hidden");
  const peak = Math.max(...labels.map((l) => fired[l]), 1);
  $("coverage-bars").innerHTML = labels
    .map((l) => {
      const f = fired[l] || 0;
      const n = fresh[l] || 0;
      const w = Math.max(1, Math.round((100 * f) / peak));
      // Percent of the PARENT fired span (CSS resolves nested % widths
      // against the parent), so the fresh fill is n/f of the fired bar.
      const wn = f ? Math.round((100 * n) / f) : 0;
      const dead = f === 0;
      return (
        `<div class="covrow${dead ? " dead" : ""}" title="fired=${f} fresh=${n}">` +
        `<span class="covlabel">${esc(l)}</span>` +
        `<span class="covbar"><span class="fired" style="width:${w}%">` +
        `<span class="fresh" style="width:${wn}%"></span></span></span>` +
        `<span class="covnum">${dead ? "DEAD" : fmtNum(f)}</span></div>`
      );
    })
    .join("");
}

// ---- fleet skew panel -----------------------------------------------------
// Per-shard load bars + skew stats + the straggler call from /fleet
// (telemetry/server.py fleet_view). Refreshes are driven by the SSE
// "fleet" events the monitor publishes per folded wave, throttled like
// /status. Panel stays hidden on single-device runs (no fleet rows).

const fleet = { lastFetch: 0 };

async function refreshFleet() {
  const now = Date.now();
  if (now - fleet.lastFetch < 1500) return;
  fleet.lastFetch = now;
  try {
    const f = await getJSON("/fleet");
    const rows = f.per_shard || [];
    if (!rows.length) return;
    $("fleet-panel").classList.remove("hidden");
    // Bar per shard on the straggler detector's cost basis: host tier
    // walls when any shard paid one, owner-side insert load otherwise.
    const anyHost = rows.some((r) => (r.probe_ms || 0) + (r.evict_ms || 0) > 0);
    const cost = (r) =>
      anyHost ? (r.probe_ms || 0) + (r.evict_ms || 0) : r.insert_load || 0;
    const peak = Math.max(...rows.map(cost), 1e-9);
    const worst = (f.stragglers || [])[0];
    $("fleet-bars").innerHTML = rows
      .map((r) => {
        const c = cost(r);
        const w = Math.max(1, Math.round((100 * c) / peak));
        const straggling = worst && worst.shard === r.shard;
        const label = `s${r.shard}` + (f.hosts > 1 ? `/h${r.host}` : "");
        return (
          `<div class="covrow${straggling ? " dead" : ""}" ` +
          `title="live=${fmtNum(r.live_lanes)} fresh=${fmtNum(r.fresh)} ` +
          `insert=${fmtNum(r.insert_load)} probe=${fmtNum(r.probe_ms)}ms">` +
          `<span class="covlabel">${esc(label)}</span>` +
          `<span class="covbar"><span class="fired" style="width:${w}%"></span></span>` +
          `<span class="covnum">${straggling ? "SLOW" : fmtNum(c)}</span></div>`
        );
      })
      .join("");
    const skew = f.skew || {};
    const parts = Object.keys(skew)
      .sort()
      .map((c) => `${esc(c)} ×${skew[c].max_over_mean.toFixed(2)}`);
    let text = parts.length ? `skew (max/mean): ${parts.join(", ")}` : "";
    if (worst && worst.persistence > 0)
      text +=
        `${text ? " — " : ""}straggler: shard ${worst.shard}` +
        ` (slowest ${(100 * worst.persistence).toFixed(0)}% of waves)`;
    $("fleet-skew").textContent = text;
  } catch (err) {
    // /fleet absent (older server) or mid-teardown; panel stays as-is
  }
}

// ---- job SLO panel --------------------------------------------------------
// Per-mode rolling latency objectives from the service's /slo endpoint
// (service/slo.py snapshot): ttfv p50/p99, the queue/compile/explore
// decomposition, burn rate vs targets. Probed once like /jobs — an
// Explorer-only serve never 404-polls for a hidden panel.

async function refreshSlo() {
  const s = await getJSON("/slo");
  const modes = s.modes || {};
  const rows = Object.keys(modes)
    .filter((m) => (modes[m].jobs || 0) > 0)
    .map((m) => {
      const v = modes[m];
      const d = v.decomposition || {};
      const p50 = (block) =>
        block && block.p50_s != null ? fmtSecs(block.p50_s) : "–";
      const burn = v.burn_rate
        ? Object.keys(v.burn_rate)
            .sort()
            .map((k) => `${esc(k)} ${v.burn_rate[k].toFixed(1)}×`)
            .join(", ")
        : "–";
      const hot = v.burn_rate &&
        Object.values(v.burn_rate).some((b) => b > 1.0);
      return (
        `<tr class="${hot ? "job-failed" : ""}">` +
        `<td>${esc(m)}</td><td>${v.jobs}</td>` +
        `<td>${p50(v.ttfv)}</td>` +
        `<td>${v.ttfv.p99_s != null ? fmtSecs(v.ttfv.p99_s) : "–"}</td>` +
        `<td>${p50(d.queue_s)}</td><td>${p50(d.compile_s)}</td>` +
        `<td>${p50(d.explore_s)}</td><td>${burn}</td></tr>`
      );
    });
  $("slo-rows").innerHTML = rows.join("");
  if (rows.length) $("slo-panel").classList.remove("hidden");
}

async function startSlo() {
  try {
    await refreshSlo();
  } catch (err) {
    return; // no /slo on this server: panel stays hidden
  }
  setInterval(() => refreshSlo().catch(() => {}), 2000);
}

function startMonitor() {
  let es;
  try {
    es = new EventSource("/events");
  } catch (err) {
    return;
  }
  let everConnected = false;
  es.addEventListener("hello", () => {
    $("monitor-panel").classList.remove("hidden");
    if (!everConnected) {
      everConnected = true;
      // Status polling only once the endpoints are known to exist —
      // a static serve must not 404-poll forever for a hidden panel.
      setInterval(refreshMonitorStatus, 2000);
    }
  });
  es.addEventListener("wave", (e) => onWaveEvent(JSON.parse(e.data)));
  es.addEventListener("storage", () => refreshMonitorStatus());
  es.addEventListener("pipeline", (e) => {
    const d = JSON.parse(e.data);
    if (d.utilization !== null && d.utilization !== undefined)
      $("mon-util").textContent = (100 * d.utilization).toFixed(1) + "%";
  });
  es.addEventListener("coverage", () => refreshMonitorStatus());
  es.addEventListener("fleet", () => refreshFleet());
  es.onerror = () => {
    // Never connected => no monitor endpoints on this server: close for
    // good, panel stays hidden. Once live, errors are transient drops —
    // leave the EventSource alone so its auto-reconnect resumes the
    // stream (the long-run case the panel exists for).
    if (!everConnected) es.close();
  };
}

// ---- job list panel -------------------------------------------------------
// Fed by the check service's /jobs endpoint (stateright_tpu.service).
// Hidden unless the serving process actually runs a CheckService — one
// probe decides, so an Explorer-only or static serve never 404-polls.

async function refreshJobs() {
  const data = await getJSON("/jobs");
  const rows = (data.jobs || []).map((j) => {
    const lat = j.latency || {};
    const unique =
      j.result && j.result.unique !== undefined ? j.result.unique : "–";
    const verdict =
      j.result === null || j.result === undefined
        ? ""
        : j.result.properties_hold
        ? " ✅"
        : " ❌";
    const cancellable = !["done", "failed", "cancelled"].includes(j.state);
    const btn = cancellable
      ? `<button class="cancel-job" data-id="${esc(j.job_id)}">✕</button>`
      : "";
    return (
      `<tr class="job-${esc(j.state)}">` +
      `<td>${esc(j.job_id)}</td><td>${esc(j.model || "")}</td>` +
      `<td>${esc(j.state)}${verdict}</td><td>${esc(unique)}</td>` +
      `<td>${lat.ttfv_s == null ? "–" : fmtSecs(lat.ttfv_s)}</td>` +
      `<td>${lat.wall_s == null ? "–" : fmtSecs(lat.wall_s)}</td>` +
      `<td>${j.preempts || 0}</td><td>${btn}</td></tr>`
    );
  });
  $("jobs-rows").innerHTML = rows.join("");
  document.querySelectorAll(".cancel-job").forEach((b) =>
    b.addEventListener("click", () =>
      fetch(`/jobs/${b.dataset.id}/cancel`, { method: "POST" })
        .then(refreshJobs)));
}

async function startJobs() {
  try {
    await refreshJobs();
  } catch (err) {
    return; // no /jobs on this server: panel stays hidden
  }
  $("jobs-panel").classList.remove("hidden");
  setInterval(() => refreshJobs().catch(() => {}), 2000);
}

refreshSteps();
refreshStatus();
setInterval(refreshStatus, 1000);
startMonitor();
startJobs();
startSlo();
