/* zipkin-tpu UI — hash-routed views (Discover, Trace, Dependencies, TPU
 * sketches) over the public JSON API only. Dependency-free by
 * construction: the box that serves it cannot fetch npm bundles.
 *
 * Security discipline (span fields are attacker-controlled — anyone can
 * POST to the collector): every string interpolated into markup goes
 * through esc(); SVG text uses textContent; trace ids are validated as
 * hex before use in URLs; event handlers are bound with addEventListener
 * + dataset indices, never inline JS built from payload strings; maps
 * (not plain objects) key anything payload-named, so "__proto__" cannot
 * poison lookups.
 */
'use strict';

const $ = q => document.querySelector(q);
const get = async p => {
  const r = await fetch(p);
  if (!r.ok) throw new Error(p.split('?')[0] + ': HTTP ' + r.status);
  return r.json();
};
const esc = s => String(s ?? '').replace(/[&<>"'`]/g, c => '&#' + c.charCodeAt(0) + ';');
const hexOnly = s => /^[0-9a-f]{1,32}$/.test(s) ? s : '';

/* µs → human units. Keeps raw µs under ~10ms (the range Lens shows raw). */
function fmtDur(us) {
  if (us == null || isNaN(us)) return '';
  if (us < 1000) return us + 'µs';
  if (us < 1e6) return (us / 1000).toFixed(us < 1e4 ? 2 : 1) + 'ms';
  return (us / 1e6).toFixed(2) + 's';
}

/* Deterministic service color: fnv-ish hash → hue. Same palette rules
 * everywhere (bars, chips, graph nodes, minimap) so a service is
 * recognizable across views. */
const _hueCache = new Map();
function svcHue(name) {
  if (_hueCache.has(name)) return _hueCache.get(name);
  let h = 2166136261;
  for (let i = 0; i < name.length; i++) { h ^= name.charCodeAt(i); h = Math.imul(h, 16777619); }
  const hue = ((h >>> 0) * 137) % 360;
  _hueCache.set(name, hue);
  return hue;
}
const svcColor = name => `hsl(${svcHue(name)},52%,44%)`;
const svcColorSoft = name => `hsl(${svcHue(name)},52%,62%)`;

/* ---------------------------------------------------------------- router */

const VIEWS = new Map();   // path prefix -> render(args, params)

/* Navigation generation: bumped on every route(). Async view code must
 * bail (`if (stale(gen)) return`) after each await before touching
 * #view, or a slow in-flight fetch would overwrite the view the user
 * navigated to meanwhile. */
let _gen = 0;
const stale = g => g !== _gen;

function route() {
  const h = (location.hash.slice(1) || '/');
  const [path, qs] = h.split('?');
  const params = new URLSearchParams(qs || '');
  const parts = path.replace(/^\/+/, '').split('/');
  const name = parts[0] || 'discover';
  const view = VIEWS.get(name) || VIEWS.get('discover');
  document.querySelectorAll('header a[data-nav]').forEach(a => {
    a.classList.toggle('active', a.dataset.nav === name);
  });
  closePanel();
  const gen = ++_gen;
  view(parts.slice(1), params, gen).catch(e => {
    if (stale(gen)) return;
    $('#view').innerHTML = `<section><p class="err">${esc(e.message)}</p></section>`;
  });
}

function nav(hash) { location.hash = hash; }

/* ------------------------------------------------------------ boot/header */

async function boot() {
  try {
    const i = await get('/info');
    $('#info').textContent = 'v' + i.zipkin.version + ' · ' + i.zipkin.flavor;
  } catch (e) { /* header version is cosmetic */ }
  window.addEventListener('hashchange', route);
  route();
}

/* ------------------------------------------------------------- discover */

let _services = null;
async function serviceList() {
  if (_services) return _services;
  try { _services = await get('/api/v2/services'); } catch (e) { _services = []; }
  return _services;
}

let _tagKeys = null;
async function tagKeyList() {
  if (_tagKeys) return _tagKeys;
  try {
    const keys = await get('/api/v2/autocompleteKeys');
    _tagKeys = Array.isArray(keys) ? keys : [];
  } catch (e) { _tagKeys = []; } // endpoint disabled: plain input
  return _tagKeys;
}

VIEWS.set('discover', async (args, params, gen) => {
  const services = await serviceList();
  if (stale(gen)) return;
  const el = $('#view');
  el.innerHTML = `
  <section><h2>Find traces</h2>
   <div style="display:flex;gap:6px;flex-wrap:wrap;align-items:center">
    <select id="svc"><option value="">all services</option></select>
    <select id="spanname"><option value="">all spans</option></select>
    <input id="annq" list="tagkeys" placeholder="annotationQuery: error and http.method=GET" style="width:22em">
    <datalist id="tagkeys"></datalist>
    <input id="mindur" type="number" placeholder="min µs" style="width:6.5em">
    <input id="maxdur" type="number" placeholder="max µs" style="width:6.5em">
    <select id="lookback">
     <option value="3600000">last hour</option>
     <option value="86400000">last day</option>
     <option value="604800000" selected>last 7 days</option>
    </select>
    <input id="limit" type="number" value="10" style="width:4.5em" title="limit">
    <select id="sort">
     <option value="newest">newest first</option>
     <option value="longest">longest first</option>
     <option value="spans">most spans</option>
    </select>
    <button id="gosearch" class="primary">search</button>
    <span style="margin-left:10px">trace id:
     <input id="tid" placeholder="hex trace id" style="width:17em">
     <button id="gotrace">open</button></span>
    <label style="margin-left:10px" title="view a span-list JSON file without storing it">
     local JSON: <input id="tracefile" type="file" accept=".json,application/json"></label>
   </div>
   <div id="traces" style="margin-top:10px"></div>
  </section>`;
  const svcSel = $('#svc');
  for (const n of services) {
    const o = document.createElement('option');
    o.value = o.textContent = n;
    svcSel.append(o);
  }
  // restore form state from the hash query so searches are shareable
  for (const [id, key] of [['svc', 'serviceName'], ['spanname', 'spanName'],
    ['annq', 'annotationQuery'], ['mindur', 'minDuration'],
    ['maxdur', 'maxDuration'], ['lookback', 'lookback'],
    ['limit', 'limit'], ['sort', 'sort']]) {
    if (params.has(key)) $('#' + id).value = params.get(key);
  }
  svcSel.addEventListener('change', loadNames);
  // autocomplete tag keys (the Lens discover suggestions) — cached per
  // session like serviceList(); best-effort
  tagKeyList().then(keys => {
    if (stale(gen)) return;
    const dl = $('#tagkeys');
    if (!dl) return;
    for (const k of keys) {
      const o = document.createElement('option');
      o.value = String(k);
      dl.append(o);
    }
  });
  $('#gosearch').addEventListener('click', () => {
    const target = '/?' + discoverQuery().toString();
    // same hash fires no hashchange — run the search directly so a
    // repeat click still picks up newly ingested traces (endTs=now is
    // applied inside findTraces)
    if (location.hash === '#' + target) findTraces();
    else nav(target);
  });
  $('#gotrace').addEventListener('click', () => {
    const id = hexOnly($('#tid').value.trim().toLowerCase());
    if (!id) { $('#traces').innerHTML = '<p class="err">not a hex trace id</p>'; return; }
    nav('/trace/' + id);
  });
  // the Lens "view my own JSON" path: render a span-list file in the
  // waterfall without ingesting it (same escaping rules apply — the
  // file is as untrusted as a POSTed payload)
  $('#tracefile').addEventListener('change', async ev => {
    const f = ev.target.files[0];
    if (!f) return;
    try {
      const spans = JSON.parse(await f.text());
      if (!Array.isArray(spans) || !spans.length) throw new Error('expected a non-empty span array');
      // element-level check: a [null] or [{}] entry would otherwise
      // blow up later inside treeOrder with a raw TypeError
      for (const s of spans) {
        if (!s || typeof s !== 'object' || typeof s.id !== 'string') {
          throw new Error('every span needs at least an "id" string');
        }
      }
      _localTrace = spans;
      nav('/trace/local');
    } catch (e) {
      $('#traces').innerHTML = `<p class="err">cannot load trace JSON: ${esc(e.message)}</p>`;
    }
  });
  if (params.has('serviceName')) await loadNames(params.get('spanName'));
  if ([...params.keys()].length) await findTraces();
});

function discoverQuery() {
  const q = new URLSearchParams();
  const setIf = (key, v) => { if (v) q.set(key, v); };
  setIf('serviceName', $('#svc').value);
  setIf('spanName', $('#spanname').value);
  setIf('annotationQuery', $('#annq').value.trim());
  setIf('minDuration', $('#mindur').value);
  setIf('maxDuration', $('#maxdur').value);
  q.set('lookback', $('#lookback').value || 7 * 864e5);
  q.set('limit', $('#limit').value || 10);
  setIf('sort', $('#sort').value !== 'newest' ? $('#sort').value : '');
  return q;
}

async function loadNames(selected) {
  const svc = $('#svc').value, sel = $('#spanname');
  sel.innerHTML = '<option value="">all spans</option>';
  if (!svc) return;
  try {
    const names = await get('/api/v2/spans?serviceName=' + encodeURIComponent(svc));
    for (const n of names) {
      const o = document.createElement('option');
      o.value = o.textContent = n;
      sel.append(o);
    }
    if (typeof selected === 'string') sel.value = selected;
  } catch (e) { /* names dropdown stays empty */ }
}

async function findTraces() {
  const gen = _gen;
  const elq = $('#traces');
  const q = discoverQuery();
  const sort = q.get('sort') || 'newest';
  q.delete('sort');
  q.set('endTs', Date.now());
  elq.innerHTML = '<p class="muted">searching…</p>';
  let traces;
  try { traces = await get('/api/v2/traces?' + q); }
  catch (e) {
    if (stale(gen)) return;
    elq.innerHTML = `<p class="err">search failed: ${esc(e.message)} (check the filter values)</p>`;
    return;
  }
  if (stale(gen)) return;
  // an empty trace array has no root span — tr.reduce with no initial
  // value throws on it and would blank the whole results table
  traces = traces.filter(tr => tr.length);
  if (!traces.length) { elq.innerHTML = '<p class="muted">no traces matched</p>'; return; }

  const rows = traces.map(tr => {
    // reduce, not Math.min(...spread): a >65k-span trace would blow the
    // JS argument-count limit (same rule as depGraph's maxC)
    const root = tr.reduce((a, b) => (a.timestamp || 1e18) < (b.timestamp || 1e18) ? a : b);
    const t0 = tr.reduce((m, s) => Math.min(m, s.timestamp || 1e18), 1e18);
    const t1 = tr.reduce((m, s) => Math.max(m, (s.timestamp || t0) + (s.duration || 0)), 0);
    // per-service share of span time, for the segmented duration bar
    const share = new Map();
    for (const s of tr) {
      const svc = (s.localEndpoint || {}).serviceName;
      if (svc && s.duration) share.set(svc, (share.get(svc) || 0) + s.duration);
    }
    return {
      spans: tr, root, dur: t1 - t0 || root.duration || 0,
      id: hexOnly(root.traceId),
      err: tr.some(s => s.tags && s.tags.error !== undefined),
      share: [...share.entries()].sort((a, b) => b[1] - a[1]),
    };
  });
  if (sort === 'longest') rows.sort((a, b) => b.dur - a.dur);
  else if (sort === 'spans') rows.sort((a, b) => b.spans.length - a.spans.length);
  else rows.sort((a, b) => (b.root.timestamp || 0) - (a.root.timestamp || 0));
  const maxDur = rows.reduce((m, r) => Math.max(m, r.dur), 1);

  let h = `<table><tr><th>start</th><th>trace</th><th>duration</th>
    <th style="width:28%">relative · by service</th><th>spans</th><th>services</th></tr>`;
  rows.forEach((r, i) => {
    const when = r.root.timestamp
      ? new Date(r.root.timestamp / 1000).toISOString().slice(0, 19).replace('T', ' ') : '';
    const segs = [];
    let off = 0;
    const total = r.share.reduce((a, [, d]) => a + d, 0) || 1;
    const w = 100 * r.dur / maxDur;
    for (const [svc, d] of r.share.slice(0, 6)) {
      const sw = w * d / total;
      segs.push(`<div style="left:${off}%;width:${Math.max(sw, 0.4)}%;background:${svcColor(svc)}"
        title="${esc(svc)}: ${esc(fmtDur(d))}"></div>`);
      off += sw;
    }
    if (!segs.length) segs.push(`<div style="left:0;width:${Math.max(w, 0.4)}%;background:#9fa8da"></div>`);
    const chips = r.share.slice(0, 4).map(([svc, d]) =>
      `<span class="chip" style="background:${svcColor(svc)}">${esc(svc)}<span class="n">${esc(fmtDur(d))}</span></span>`);
    h += `<tr class="trow" data-id="${r.id}"><td>${esc(when)}</td>
      <td>${esc(r.id.slice(0, 16))}${r.err ? '<span class="badge-err">error</span>' : ''}</td>
      <td>${esc(fmtDur(r.dur))}</td>
      <td><div class="durbar">${segs.join('')}</div></td>
      <td>${r.spans.length}</td>
      <td>${chips.join('')}${r.share.length > 4 ? '<span class="muted"> +' + (r.share.length - 4) + '</span>' : ''}</td></tr>`;
  });
  elq.innerHTML = h + '</table>';
  elq.querySelectorAll('tr.trow').forEach(row =>
    row.addEventListener('click', () => nav('/trace/' + row.dataset.id)));
}

/* ---------------------------------------------------------------- trace */

let curSpans = [];          // tree-ordered spans of the open trace
let curTree = [];           // [[span, depth], ...]
let collapsed = new Set();  // indices whose subtree is folded
let curT0 = 0, curTotal = 1;  // trace time origin/extent for renderRows
let pctCtx = new Map();     // "service|span" -> {p50, p99}
let _localTrace = null;     // spans loaded from a local JSON file

async function loadPctCtx() {
  if (pctCtx.size) return;
  try {
    const rows = await get('/api/v2/tpu/percentiles?q=0.5,0.99');
    for (const x of rows) pctCtx.set(x.serviceName + '|' + x.spanName,
      { p50: x.quantiles['0.5'], p99: x.quantiles['0.99'] });
  } catch (e) { /* TPU sketches not enabled: waterfall renders without context */ }
}

function treeOrder(spans) {
  // Lens-style waterfall order: DFS over the span tree (parentId edges;
  // a shared SERVER span nests under its same-id client half), children
  // by timestamp; orphans (missing parents) surface as roots.
  // Returns [[span, depth], ...]. Cycle-safe via the visited set.
  const byId = new Map();
  for (const s of spans) {
    const k = s.id;
    if (!byId.has(k)) byId.set(k, []);
    byId.get(k).push(s);
  }
  const parentOf = s => {
    if (s.shared) {  // server half: parent is the client half (same id)
      const mates = (byId.get(s.id) || []).filter(m => m !== s && !m.shared);
      if (mates.length) return mates[0];
    }
    if (s.parentId && byId.has(s.parentId)) {
      // prefer the SHARED rendition (the server half is the closer tree
      // node — SpanNode's index preference), so server-created children
      // nest under the server span, not beside it
      const c = byId.get(s.parentId);
      return c.find(m => m.shared) || c[0];
    }
    return null;
  };
  const kids = new Map(), roots = [];
  for (const s of spans) {
    const p = parentOf(s);
    if (p) { if (!kids.has(p)) kids.set(p, []); kids.get(p).push(s); }
    else roots.push(s);
  }
  const ts = s => s.timestamp || 1e18;
  roots.sort((a, b) => ts(a) - ts(b));
  const out = [], seen = new Set();
  const walk = (s, d) => {
    if (seen.has(s)) return;
    seen.add(s);
    out.push([s, d]);
    const c = (kids.get(s) || []).sort((a, b) => ts(a) - ts(b));
    for (const k of c) walk(k, d + 1);
  };
  for (const r of roots) walk(r, 0);
  for (const s of spans) if (!seen.has(s)) out.push([s, 0]); // cycle leftovers
  return out;
}

/* #spans whose subtree a row at index i covers: following rows with
 * depth > depth[i], contiguously. */
function subtreeEnd(i) {
  const d = curTree[i][1];
  let j = i + 1;
  while (j < curTree.length && curTree[j][1] > d) j++;
  return j;
}

VIEWS.set('trace', async (args, params, gen) => {
  let id, spans;
  if (args[0] === 'local' && _localTrace) {
    // a file loaded on the Discover page; 'local' never collides with
    // hexOnly ids and a cold deep-link to #/trace/local falls through
    // to the hex branch's error
    id = 'local';
    spans = _localTrace;
    await loadPctCtx();
  } else {
    id = hexOnly((args[0] || '').toLowerCase());
    if (!id) throw new Error('not a hex trace id');
    [spans] = await Promise.all([get('/api/v2/trace/' + id), loadPctCtx()]);
  }
  if (stale(gen)) return;
  curTree = treeOrder(spans);
  curSpans = curTree.map(([s]) => s);
  collapsed = new Set();
  const svcs = [...new Set(spans.map(s => (s.localEndpoint || {}).serviceName).filter(Boolean))];
  // reduce, not Math.min(...spread): a >65k-span trace would blow the
  // JS argument-count limit
  const t0 = spans.reduce((m, s) => Math.min(m, s.timestamp || 1e18), 1e18);
  const total = spans.reduce((m, s) => Math.max(m, (s.timestamp || t0) + (s.duration || 0)), 0) - t0 || 1;
  const depth = curTree.reduce((m, [, d]) => Math.max(m, d), 0);
  const errs = spans.filter(s => s.tags && s.tags.error !== undefined).length;

  const el = $('#view');
  el.innerHTML = `
  <section>
   <h2>trace ${esc(id)}
    <span class="muted">${spans.length} spans · ${svcs.length} services · depth ${depth + 1}
     · ${esc(fmtDur(total))}${errs ? ` · <span class="err">${errs} error spans</span>` : ''}</span>
    <span style="float:right">
     <button id="expandall">expand all</button>
     <button id="dljson">download JSON</button>
     <a href="#/" style="margin-left:8px">← back to search</a></span>
   </h2>
   <div id="legend" style="margin:6px 0"></div>
   <svg id="minimap" height="54"></svg>
   <table class="wf"><tr><th class="names">service · span</th>
    <th class="tl"><div id="ruler"></div></th>
    <th style="width:7em">duration</th><th style="width:5.5em">vs p99</th></tr>
    <tbody id="wfrows"></tbody></table>
  </section>`;

  // legend: service chips with span counts, colored like the bars
  const counts = new Map();
  for (const s of spans) {
    const svc = (s.localEndpoint || {}).serviceName;
    if (svc) counts.set(svc, (counts.get(svc) || 0) + 1);
  }
  $('#legend').innerHTML = [...counts.entries()].sort((a, b) => b[1] - a[1]).map(([svc, n]) =>
    `<span class="chip" style="background:${svcColor(svc)}">${esc(svc)}<span class="n">×${n}</span></span>`).join('');

  // ruler: 5 ticks, µs/ms adaptive
  $('#ruler').innerHTML = [0, 0.25, 0.5, 0.75, 1].map(f =>
    `<span style="left:${f * 100}%">${esc(fmtDur(Math.round(total * f)))}</span>`).join('');

  $('#dljson').addEventListener('click', () => {
    const blob = new Blob([JSON.stringify(spans, null, 2)], { type: 'application/json' });
    const a = document.createElement('a');
    a.href = URL.createObjectURL(blob);
    a.download = 'trace-' + id + '.json';
    a.click();
    URL.revokeObjectURL(a.href);
  });
  $('#expandall').addEventListener('click', () => { collapsed.clear(); renderRows(); });

  curT0 = t0;
  curTotal = total;
  drawMinimap(t0, total);
  renderRows();
});

function drawMinimap(t0, total) {
  const svg = $('#minimap');
  const NS = 'http://www.w3.org/2000/svg';
  svg.innerHTML = '';
  const W = 1000, H = 54;
  svg.setAttribute('viewBox', `0 0 ${W} ${H}`);
  svg.setAttribute('preserveAspectRatio', 'none');
  const n = curTree.length;
  const rh = Math.max(Math.min(H / n, 4), 0.8);
  curTree.forEach(([s], i) => {
    const x = W * ((s.timestamp || t0) - t0) / total;
    const w = Math.max(W * (s.duration || 0) / total, 1.5);
    const r = document.createElementNS(NS, 'rect');
    const err = s.tags && s.tags.error !== undefined;
    const svc = (s.localEndpoint || {}).serviceName || '';
    r.setAttribute('x', x); r.setAttribute('y', Math.min(i * rh, H - rh));
    r.setAttribute('width', w); r.setAttribute('height', Math.max(rh - 0.4, 0.6));
    r.setAttribute('fill', err ? '#b71c1c' : svcColorSoft(svc));
    svg.append(r);
  });
  svg.addEventListener('click', ev => {
    // clientY relative to the svg box (offsetY can be rect-relative
    // when the click lands on a child), then into viewBox units and
    // divided by the DRAWN row height — rh is clamped, so frac*n would
    // mis-target any trace where rh != H/n
    const box = svg.getBoundingClientRect();
    const vbY = (ev.clientY - box.top) / (box.height || 1) * H;
    let idx = Math.max(0, Math.min(Math.floor(vbY / rh), n - 1));
    // the exact index may sit inside a collapsed subtree (its row is
    // not rendered) — walk up to the nearest rendered ancestor row
    let row = null;
    while (idx >= 0 && !(row = document.querySelector(`tr.srow[data-idx="${idx}"]`))) idx--;
    if (row) selectRow(row, 'center');
  });
}

function renderRows() {
  const t0 = curT0, total = curTotal;
  const tbody = $('#wfrows');
  _selRow = null;
  let h = '';
  let skipUntil = -1;
  curTree.forEach(([s, depthv], i) => {
    if (i < skipUntil) return;
    const end = subtreeEnd(i);
    const nkids = end - i - 1;
    const folded = collapsed.has(i);
    if (folded) skipUntil = end;
    const off = 100 * ((s.timestamp || t0) - t0) / total;
    const w = Math.max(100 * (s.duration || 0) / total, 0.4);
    const err = s.tags && s.tags.error !== undefined;
    const svc = (s.localEndpoint || {}).serviceName || '';
    const key = svc + '|' + (s.name || '');
    const ctx = pctCtx.get(key);
    // duration-percentile context from the device sketches (the Lens
    // "how slow is this span vs its peers" panel)
    let vs = '';
    if (ctx && s.duration) {
      const r = s.duration / ctx.p99;
      vs = r >= 1 ? `<span class="slow">${r.toFixed(1)}x p99</span>`
        : s.duration >= ctx.p50 ? '&gt;p50' : '&lt;p50';
    }
    const pad = Math.min(depthv, 14) * 13;
    const caret = nkids
      ? `<span class="caret" data-fold="${i}">${folded ? '▸' : '▾'}</span>`
      : '<span class="caret"></span>';
    const grid = [25, 50, 75].map(p => `<div class="grid" style="left:${p}%"></div>`).join('');
    h += `<tr class="srow ${err ? 'err' : ''}" data-idx="${i}">
      <td class="names" style="padding-left:${6 + pad}px">${caret}
        <span class="svc-dot" style="background:${svcColor(svc)}"></span>${esc(svc)}
        <span class="muted">· ${esc(s.name || '')} ${esc(s.kind || '')}${s.shared ? ' shared' : ''}</span>
        ${folded ? `<span class="hiddenkids">+${nkids} hidden</span>` : ''}</td>
      <td class="tl">${grid}<div class="bar ${err ? 'err' : ''}"
        style="margin-left:${off}%;width:${w}%;background:${svcColor(svc)}"></div></td>
      <td>${esc(fmtDur(s.duration))}</td><td>${vs}</td></tr>`;
  });
  tbody.innerHTML = h;
  tbody.querySelectorAll('.caret[data-fold]').forEach(c =>
    c.addEventListener('click', ev => {
      ev.stopPropagation();
      const i = +c.dataset.fold;
      collapsed.has(i) ? collapsed.delete(i) : collapsed.add(i);
      renderRows();
    }));
  tbody.querySelectorAll('tr.srow').forEach(row =>
    row.addEventListener('click', () => selectRow(row)));
}

/* Single selection anchor for click, minimap and keyboard paths —
 * tracked so selecting is O(1), not a sweep over (possibly 65k) rows. */
let _selRow = null;
function selectRow(row, scroll) {
  if (_selRow && _selRow !== row) _selRow.classList.remove('sel');
  _selRow = row;
  row.classList.add('sel');
  if (scroll) row.scrollIntoView({ block: scroll });
  spanDetail(+row.dataset.idx);
}

/* Keyboard navigation on the waterfall: ↑/↓ move the selection over the
 * RENDERED rows, ←/→ fold/unfold the selected subtree, Escape closes
 * the span panel. Inactive while typing in a form control. */
document.addEventListener('keydown', ev => {
  const tag = (ev.target.tagName || '').toLowerCase();
  if (tag === 'input' || tag === 'select' || tag === 'textarea') return;
  // Escape works on EVERY view with a span panel (the Dependencies view
  // opens one too), so it is handled before the trace-route gate
  if (ev.key === 'Escape') { closePanel(); return; }
  if (!location.hash.startsWith('#/trace/')) return;
  if (ev.key === 'ArrowDown' || ev.key === 'ArrowUp') {
    ev.preventDefault();
    const anchor = _selRow && _selRow.isConnected ? _selRow : null;
    const next = anchor
      ? (ev.key === 'ArrowDown'
        ? anchor.nextElementSibling : anchor.previousElementSibling)
      : document.querySelector('tr.srow');
    if (next && next.classList.contains('srow')) selectRow(next, 'nearest');
  } else if ((ev.key === 'ArrowLeft' || ev.key === 'ArrowRight')
      && _selRow && _selRow.isConnected) {
    const i = +_selRow.dataset.idx;
    if (subtreeEnd(i) - i - 1 === 0) return;  // leaf: nothing to fold
    // no-op fold/unfold must not rebuild a (possibly 65k-row) waterfall
    if ((ev.key === 'ArrowLeft') === collapsed.has(i)) return;
    ev.preventDefault();
    if (ev.key === 'ArrowLeft') collapsed.add(i);
    else collapsed.delete(i);
    renderRows();
    const again = document.querySelector(`tr.srow[data-idx="${i}"]`);
    if (again) selectRow(again);
  }
});

function spanDetail(i) {
  const s = curSpans[i];
  if (!s) return;
  const row = (k, v) => v === undefined || v === '' ? '' : `<tr><th>${esc(k)}</th><td>${esc(v)}</td></tr>`;
  const ep = e => e ? [e.serviceName, e.ipv4 || e.ipv6, e.port].filter(Boolean).join(' ') : '';
  let h = `<button class="close" id="panelclose">×</button>
    <h3>${esc(s.name || '(unnamed)')} <span class="muted">${esc(s.kind || '')}</span></h3><table>`;
  h += row('traceId', s.traceId) + row('spanId', s.id) + row('parentId', s.parentId)
    + row('shared', s.shared ? 'true' : '') + row('timestamp µs', s.timestamp)
    + row('duration', fmtDur(s.duration))
    + row('local', ep(s.localEndpoint)) + row('remote', ep(s.remoteEndpoint));
  const ctx = pctCtx.get(((s.localEndpoint || {}).serviceName || '') + '|' + (s.name || ''));
  if (ctx) h += row('peer p50', fmtDur(Math.round(ctx.p50))) + row('peer p99', fmtDur(Math.round(ctx.p99)));
  h += '</table>';
  if (s.annotations && s.annotations.length) {
    h += '<h3>annotations</h3><table>';
    for (const a of s.annotations) h += row(a.timestamp, a.value);
    h += '</table>';
  }
  const tags = s.tags || {};
  if (Object.keys(tags).length) {
    h += '<h3>tags</h3><table>';
    for (const k of Object.keys(tags).sort())
      h += `<tr><th class="${k === 'error' ? 'err' : ''}">${esc(k)}</th><td>${esc(tags[k])}</td></tr>`;
    h += '</table>';
  }
  openPanel(h);
}

function openPanel(html) {
  const p = $('#spanpanel');
  p.innerHTML = html;
  p.style.display = 'block';
  const c = $('#panelclose');
  if (c) c.addEventListener('click', closePanel);
}
function closePanel() {
  const p = $('#spanpanel');
  if (p) { p.style.display = 'none'; p.innerHTML = ''; }
}

/* ---------------------------------------------------------- dependencies */

let curLinks = [];

VIEWS.set('dependencies', async (args, params) => {
  const lookback = params.get('lookback') || 7 * 864e5;
  const el = $('#view');
  el.innerHTML = `
  <section><h2>Dependencies
    <span class="muted">service call graph from <code>/api/v2/dependencies</code> —
    click a service for its callers/callees</span></h2>
   <select id="deplb">
    <option value="3600000">last hour</option>
    <option value="86400000">last day</option>
    <option value="604800000">last 7 days</option>
    <option value="2592000000">last 30 days</option>
   </select>
   <button id="deprefresh" class="primary">refresh</button>
   <svg id="depgraph" width="100%" height="0" viewBox="0 0 800 500"></svg>
   <table id="deptab"></table>
  </section>`;
  $('#deplb').value = String(lookback);
  $('#deprefresh').addEventListener('click', () => {
    const target = '/dependencies?lookback=' + $('#deplb').value;
    // same hash fires no hashchange — refresh must refetch regardless
    if (location.hash === '#' + target) deps(+$('#deplb').value);
    else nav(target);
  });
  await deps(+lookback);
});

async function deps(lookback) {
  const gen = _gen;
  let links;
  try {
    links = await get('/api/v2/dependencies?endTs=' + Date.now() + '&lookback=' + lookback);
  } catch (e) {
    // refresh clicks call deps() directly — a failed refetch must show
    // inline, not vanish as an unhandled rejection behind stale data
    if (stale(gen)) return;
    $('#deptab').innerHTML = `<tr><td class="err">dependencies fetch failed: ${esc(e.message)}</td></tr>`;
    $('#depgraph').setAttribute('height', '0');
    return;
  }
  if (stale(gen)) return;
  curLinks = links;
  const t = $('#deptab');
  let h = '<tr><th>parent</th><th>child</th><th>calls</th><th>errors</th><th>error rate</th></tr>';
  const sorted = [...links].sort((a, b) => (b.callCount || 0) - (a.callCount || 0));
  sorted.forEach(l => {
    const rate = l.callCount ? (100 * (l.errorCount || 0) / l.callCount) : 0;
    h += `<tr class="trow" data-svc="${esc(l.parent)}">
      <td><span class="svc-dot" style="background:${svcColor(l.parent)}"></span>${esc(l.parent)}</td>
      <td><span class="svc-dot" style="background:${svcColor(l.child)}"></span>${esc(l.child)}</td>
      <td>${esc(l.callCount)}</td>
      <td class="${l.errorCount ? 'err' : ''}">${esc(l.errorCount || 0)}</td>
      <td class="${rate > 1 ? 'err' : 'muted'}">${rate.toFixed(rate && rate < 10 ? 1 : 0)}%</td></tr>`;
  });
  t.innerHTML = h;
  t.querySelectorAll('tr.trow').forEach(row =>
    row.addEventListener('click', () => serviceDetail(row.dataset.svc)));
  depGraph(links);
}

function serviceDetail(name) {
  // callers/callees panel for one service, from the loaded link set
  const inbound = curLinks.filter(l => l.child === name);
  const outbound = curLinks.filter(l => l.parent === name);
  const sum = ls => ls.reduce((a, l) => a + (l.callCount || 0), 0);
  const errs = ls => ls.reduce((a, l) => a + (l.errorCount || 0), 0);
  const table = (ls, key) => ls.length
    ? '<table>' + ls.sort((a, b) => b.callCount - a.callCount).map(l =>
      `<tr><th><span class="svc-dot" style="background:${svcColor(l[key])}"></span>${esc(l[key])}</th>
       <td>${esc(l.callCount)} calls</td>
       <td class="${l.errorCount ? 'err' : 'muted'}">${esc(l.errorCount || 0)} errors</td></tr>`).join('') + '</table>'
    : '<p class="muted">none</p>';
  openPanel(`<button class="close" id="panelclose">×</button>
    <h3><span class="svc-dot" style="background:${svcColor(name)}"></span>${esc(name)}</h3>
    <table>
     <tr><th>calls in</th><td>${sum(inbound)} (${errs(inbound)} errors)</td></tr>
     <tr><th>calls out</th><td>${sum(outbound)} (${errs(outbound)} errors)</td></tr>
    </table>
    <h3>callers (${inbound.length})</h3>${table(inbound, 'parent')}
    <h3>callees (${outbound.length})</h3>${table(outbound, 'child')}
    <p><a href="#/?serviceName=${encodeURIComponent(name)}&lookback=604800000&limit=10">find traces →</a></p>`);
}

function depGraph(links) {
  // service graph (the Lens dependencies view): nodes on a circle,
  // directed edges with width ~ log(calls), red when errors flow.
  // Built with createElementNS + textContent only — span/service names
  // are attacker-controlled and never touch innerHTML here.
  const svg = $('#depgraph');
  const NS = 'http://www.w3.org/2000/svg';
  svg.innerHTML = '';
  // rank services by call volume so a >48-service graph keeps the heavy
  // hitters, and SAY what was dropped (a silently truncated graph reads
  // as "those call paths do not exist"). Maps, not plain objects:
  // service names are attacker-controlled and "__proto__"/"constructor"
  // would corrupt object-keyed lookups.
  const vol = new Map();
  for (const l of links) {
    vol.set(l.parent, (vol.get(l.parent) || 0) + (l.callCount || 0));
    vol.set(l.child, (vol.get(l.child) || 0) + (l.callCount || 0));
  }
  const all = [...vol.keys()].sort((a, b) => vol.get(b) - vol.get(a));
  const names = all.slice(0, 48);
  if (!names.length) { svg.setAttribute('height', '0'); return; }
  svg.setAttribute('height', '500');
  const cx = 400, cy = 250, R = Math.min(200, 60 + names.length * 8);
  const pos = new Map();
  names.forEach((n, i) => {
    const a = 2 * Math.PI * i / names.length - Math.PI / 2;
    pos.set(n, [cx + R * Math.cos(a), cy + R * Math.sin(a)]);
  });
  const el = (k, at) => {
    const e = document.createElementNS(NS, k);
    for (const [a, v] of Object.entries(at)) e.setAttribute(a, v);
    return e;
  };
  // reduce, not Math.max(...spread): a 100k-link response would blow
  // the JS argument-count limit
  const maxC = links.reduce((m, l) => Math.max(m, l.callCount || 1), 1);
  for (const l of links) {
    const p = pos.get(l.parent), c = pos.get(l.child);
    if (!p || !c) continue;
    const w = 0.8 + 3 * Math.log(1 + (l.callCount || 1)) / Math.log(1 + maxC);
    // curve through a point pulled toward the center so opposite-
    // direction edges between the same pair stay distinguishable
    const mx = (p[0] + c[0]) / 2 + (cy - (p[1] + c[1]) / 2) * 0.25,
      my = (p[1] + c[1]) / 2 + ((p[0] + c[0]) / 2 - cx) * 0.25;
    const path = el('path', {
      d: `M${p[0]},${p[1]} Q${mx},${my} ${c[0]},${c[1]}`,
      fill: 'none', stroke: l.errorCount ? '#b71c1c' : '#7986cb',
      'stroke-width': w, opacity: 0.75,
    });
    const tip = document.createElementNS(NS, 'title');
    tip.textContent = `${l.parent} -> ${l.child}: ${l.callCount} calls, ${l.errorCount || 0} errors`;
    path.append(tip);
    svg.append(path);
    // direction tick at 70% along the curve
    const tx = 0.09 * p[0] + 0.42 * mx + 0.49 * c[0],
      ty = 0.09 * p[1] + 0.42 * my + 0.49 * c[1];
    svg.append(el('circle', {
      cx: tx, cy: ty, r: Math.max(w, 1.6),
      fill: l.errorCount ? '#b71c1c' : '#3f51b5',
    }));
  }
  for (const n of names) {
    const [x, y] = pos.get(n);
    const dot = el('circle', { cx: x, cy: y, r: 6, fill: svcColor(n), cursor: 'pointer' });
    dot.addEventListener('click', () => serviceDetail(n));
    svg.append(dot);
    const label = el('text', {
      x: x + (x >= cx ? 9 : -9), y: y + 4, 'font-size': '11',
      'text-anchor': x >= cx ? 'start' : 'end', fill: '#222', cursor: 'pointer',
    });
    label.textContent = n;  // textContent: no markup interpretation
    label.addEventListener('click', () => serviceDetail(n));
    svg.append(label);
  }
  if (all.length > names.length) {
    const note = el('text', { x: 10, y: 20, 'font-size': '12', fill: '#b71c1c' });
    note.textContent = `${all.length - names.length} lower-volume services not shown (full list in the table below)`;
    svg.append(note);
  }
}

/* -------------------------------------------------------------- sketches */

VIEWS.set('sketches', async (args, params) => {
  const el = $('#view');
  el.innerHTML = `
  <section><h2>Latency percentiles
    <span class="muted">served from the device t-digest / histogram sketches</span></h2>
   <label>window: <select id="pctwin">
    <option value="">all time (digest)</option>
    <option value="3600000">last hour (sliced histograms)</option>
    <option value="86400000">last day (sliced histograms)</option>
   </select></label>
   <button id="pctrefresh" class="primary">refresh</button>
   <table id="pcttab"></table>
  </section>
  <section><h2>Trace cardinalities <span class="muted">device HLL estimates</span></h2>
   <table id="cardtab"></table>
  </section>
  <section><h2>Ingest counters
    <span class="muted">host-mirrored exact counters · <a href="/metrics">/metrics</a> ·
    <a href="/prometheus">/prometheus</a></span></h2>
   <button id="snap">snapshot now</button> <span id="snapout" class="muted"></span>
   <table id="ctrtab"></table>
  </section>`;
  $('#pctrefresh').addEventListener('click', loadPcts);
  $('#snap').addEventListener('click', async () => {
    const out = $('#snapout');
    try {
      const r = await fetch('/api/v2/tpu/snapshot', { method: 'POST' });
      out.textContent = r.ok ? 'saved: ' + (await r.json()).snapshot : 'HTTP ' + r.status + ': ' + await r.text();
    } catch (e) { out.textContent = String(e); }
  });
  await loadOverview();
});

let _pctSort = 'count';
function renderPcts(rows) {
  const t = $('#pcttab');
  const key = { count: r => -r.count, p50: r => -r.quantiles['0.5'], p99: r => -r.quantiles['0.99'],
    service: r => r.serviceName }[_pctSort] || (r => -r.count);
  rows.sort((a, b) => { const x = key(a), y = key(b); return x < y ? -1 : x > y ? 1 : 0; });
  let h = `<tr><th class="sortable" data-k="service">service</th><th>span</th>
    <th class="sortable" data-k="count">count</th><th class="sortable" data-k="p50">p50</th>
    <th>p90</th><th class="sortable" data-k="p99">p99</th></tr>`;
  for (const x of rows.slice(0, 500)) {
    h += `<tr><td><span class="svc-dot" style="background:${svcColor(x.serviceName)}"></span>${esc(x.serviceName)}</td>
      <td>${esc(x.spanName)}</td><td>${esc(x.count)}</td>
      <td>${esc(fmtDur(Math.round(x.quantiles['0.5'])))}</td>
      <td>${esc(fmtDur(Math.round(x.quantiles['0.9'])))}</td>
      <td>${esc(fmtDur(Math.round(x.quantiles['0.99'])))}</td></tr>`;
  }
  if (rows.length > 500) h += `<tr><td class="muted" colspan="6">${rows.length - 500} more rows not shown</td></tr>`;
  t.innerHTML = h;
  t.querySelectorAll('th.sortable').forEach(th =>
    th.addEventListener('click', () => { _pctSort = th.dataset.k; loadPcts(); }));
}

async function loadPcts() {
  const gen = _gen;
  const t = $('#pcttab');
  const win = $('#pctwin').value;
  // no window = the all-time digest view, which the coalesced overview
  // serves (with cards + counters) in ONE request and one device pull
  if (!win) return loadOverview();
  const q = '/api/v2/tpu/percentiles?q=0.5,0.9,0.99&lookback=' + win;
  let rows;
  try { rows = await get(q); }
  catch (e) { if (!stale(gen)) t.innerHTML = '<tr><td class="muted">TPU storage not enabled</td></tr>'; return; }
  if (stale(gen)) return;
  renderPcts(rows);
}

function renderCards(cards) {
  const t = $('#cardtab');
  let h = '<tr><th>service</th><th>distinct traces (est.)</th></tr>';
  const entries = Object.entries(cards).sort((a, b) => b[1] - a[1]);
  for (const [name, n] of entries) {
    const label = name === '_global' ? '(all services)' : name;
    h += `<tr><td>${name === '_global' ? '<b>' + esc(label) + '</b>' : esc(label)}</td>
      <td>${Math.round(n).toLocaleString()}</td></tr>`;
  }
  t.innerHTML = h;
}

function renderCounters(ctr) {
  const t = $('#ctrtab');
  let h = '<tr><th>counter</th><th>value</th></tr>';
  for (const k of Object.keys(ctr).sort())
    h += `<tr><td>${esc(k)}</td><td>${Number(ctr[k]).toLocaleString()}</td></tr>`;
  t.innerHTML = h;
}

async function loadOverview() {
  const gen = _gen;
  try {
    const o = await get('/api/v2/tpu/overview?q=0.5,0.9,0.99');
    if (stale(gen)) return;
    renderPcts(o.percentiles);
    renderCards(o.cardinalities);
    renderCounters(o.counters);
  } catch (e) {
    if (stale(gen)) return;
    // older server without the coalesced endpoint: three requests
    await loadLegacyPcts();
    await loadCards();
    await loadCounters();
  }
}

async function loadLegacyPcts() {
  const gen = _gen;
  const t = $('#pcttab');
  let rows;
  try { rows = await get('/api/v2/tpu/percentiles?q=0.5,0.9,0.99'); }
  catch (e) { if (!stale(gen)) t.innerHTML = '<tr><td class="muted">TPU storage not enabled</td></tr>'; return; }
  if (stale(gen)) return;
  renderPcts(rows);
}

async function loadCards() {
  const gen = _gen;
  const t = $('#cardtab');
  try {
    const cards = await get('/api/v2/tpu/cardinalities');
    if (stale(gen)) return;
    renderCards(cards);
  } catch (e) { if (!stale(gen)) t.innerHTML = '<tr><td class="muted">TPU storage not enabled</td></tr>'; }
}

async function loadCounters() {
  const gen = _gen;
  const t = $('#ctrtab');
  try {
    const ctr = await get('/api/v2/tpu/counters');
    if (stale(gen)) return;
    renderCounters(ctr);
  } catch (e) { if (stale(gen)) return; t.innerHTML = '<tr><td class="muted">TPU storage not enabled</td></tr>'; }
}

boot();
