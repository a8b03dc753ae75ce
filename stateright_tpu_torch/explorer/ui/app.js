// Explorer SPA. Speaks the same JSON protocol as the reference UI
// (GET /.status, GET /.states/<fp/fp/...>, POST /.runtocompletion);
// re-written from scratch in dependency-free vanilla JS.

"use strict";

const $ = (id) => document.getElementById(id);

// Path of fingerprints from an init state to the current state, and
// the steps (actions) taken, aligned one action per fingerprint.
let path = [];        // [{fingerprint, action}]
let steps = [];       // current next-step views from the server
let selected = 0;

function pathUrl(extra) {
  const fps = path.map((p) => p.fingerprint);
  if (extra !== undefined) fps.push(extra);
  return "/.states/" + fps.join("/");
}

async function fetchStatus() {
  try {
    const r = await fetch("/.status");
    const s = await r.json();
    $("status").textContent =
      `${s.model} — states=${s.state_count} unique=${s.unique_state_count}` +
      ` depth=${s.max_depth}${s.done ? " (done)" : ""}`;
    renderProperties(s.properties, s.done);
  } catch (e) {
    $("status").textContent = "server unreachable";
  }
}

function renderProperties(props, done) {
  const ul = $("properties");
  ul.innerHTML = "";
  for (const [expectation, name, discovery] of props) {
    const li = document.createElement("li");
    const wantDiscovery = expectation === "Sometimes";
    let cls, text;
    if (discovery) {
      cls = wantDiscovery ? "prop-ok" : "prop-bad";
      text = `${expectation} "${name}": ${wantDiscovery ? "example" : "counterexample"} found`;
    } else if (done) {
      cls = wantDiscovery ? "prop-bad" : "prop-ok";
      text = `${expectation} "${name}": ${wantDiscovery ? "no example" : "holds"}`;
    } else {
      cls = "prop-search";
      text = `${expectation} "${name}": searching`;
    }
    li.className = cls;
    li.textContent = text;
    if (discovery) {
      const a = document.createElement("span");
      a.className = "prop-link";
      a.textContent = " [open]";
      a.onclick = () => loadDiscovery(discovery);
      li.appendChild(a);
      li.style.cursor = "pointer";
    }
    ul.appendChild(li);
  }
}

async function loadDiscovery(encoded) {
  // encoded = "fp/fp/fp"; walk it from the root, recording actions.
  const fps = encoded.split("/");
  path = [];
  let views = await (await fetch("/.states/")).json();
  for (const fp of fps) {
    const v = views.find((x) => x.fingerprint === fp);
    path.push({
      fingerprint: fp,
      action: v ? v.action || "(init)" : "?",
      state: v ? v.state : "",
    });
    views = await (await fetch(pathUrl())).json();
  }
  steps = views;
  selected = 0;
  render(stateOfLast());
}

let lastStateText = "";
function stateOfLast() { return lastStateText; }

async function loadSteps(stateText) {
  const r = await fetch(pathUrl());
  if (!r.ok) { $("state").textContent = await r.text(); return; }
  steps = await r.json();
  selected = 0;
  render(stateText);
}

function render(stateText) {
  lastStateText = stateText || "";
  $("state").textContent = lastStateText;
  const ol = $("path");
  ol.innerHTML = "";
  path.forEach((p, i) => {
    const li = document.createElement("li");
    li.textContent = p.action || "(init)";
    li.title = p.fingerprint;
    li.onclick = () => truncateTo(i);
    ol.appendChild(li);
  });
  const ul = $("steps");
  ul.innerHTML = "";
  steps.forEach((s, i) => {
    const li = document.createElement("li");
    const ignored = s.fingerprint === undefined;
    li.textContent = (s.action || "(init)") + (ignored ? " — ignored" : "");
    li.className = (i === selected ? "selected" : "") + (ignored ? " ignored" : "");
    if (!ignored) li.onclick = () => choose(i);
    ul.appendChild(li);
  });
  const svg = steps[selected] && steps[selected].svg;
  $("svg").innerHTML = svg || "";
  fetchStatus();
}

async function choose(i) {
  const s = steps[i];
  if (!s || s.fingerprint === undefined) return;
  path.push({ fingerprint: s.fingerprint, action: s.action || "(init)", state: s.state });
  await loadSteps(s.state);
}

function currentStateText() {
  return path.length ? path[path.length - 1].state || "" : "";
}

async function truncateTo(i) {
  path = path.slice(0, i + 1);
  await loadSteps(currentStateText());
}

async function up() {
  if (path.length === 0) return;
  path.pop();
  await loadSteps(currentStateText());
}

async function init() {
  path = [];
  await loadSteps("");
}

document.addEventListener("keydown", (e) => {
  if (e.key === "j") { selected = Math.min(selected + 1, steps.length - 1); render(lastStateText); }
  else if (e.key === "k") { selected = Math.max(selected - 1, 0); render(lastStateText); }
  else if (e.key === "Enter") { choose(selected); }
  else if (e.key === "Backspace") { e.preventDefault(); up(); }
});

$("run").onclick = async () => {
  await fetch("/.runtocompletion", { method: "POST" });
  fetchStatus();
};

setInterval(fetchStatus, 2000);
init();
