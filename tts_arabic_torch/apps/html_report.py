"""HTML listening-page builder (reference `utils/make_html.py` equivalent;
the port's copy of the JAX package's `apps/html_report.py`): styled sample
pages with single / A-B / multi-audio entries and a volume control."""
from __future__ import annotations

import html
import pathlib
from typing import List, Optional, Sequence

_STYLE = """
body { font-family: system-ui, sans-serif; margin: 2em auto; max-width: 900px;
       background: #fafafa; color: #222; }
.entry { background: #fff; border: 1px solid #ddd; border-radius: 8px;
         padding: 1em; margin: 0.8em 0; }
.text { font-size: 1.15em; margin-bottom: 0.5em; direction: rtl; }
.label { color: #666; font-size: 0.85em; margin-right: 0.6em; }
audio { width: 100%; margin-top: 0.3em; }
h1 { font-size: 1.3em; }
"""

_VOLUME_SCRIPT = """
<script>
const vol = document.getElementById('volume');
function setVol() { document.querySelectorAll('audio')
  .forEach(a => a.volume = vol.value); }
vol.addEventListener('input', setVol); window.addEventListener('load', setVol);
</script>
"""


def make_sample_entry(text: str, audio_path: str,
                      label: Optional[str] = None) -> str:
    lab = f'<span class="label">{html.escape(label)}</span>' if label else ""
    return (f'<div class="entry"><div class="text">{html.escape(text)}</div>'
            f'{lab}<audio controls preload="none" '
            f'src="{html.escape(audio_path)}"></audio></div>')


def make_double_entry(text: str, audio_a: str, audio_b: str,
                      label_a: str = "A", label_b: str = "B") -> str:
    return (f'<div class="entry"><div class="text">{html.escape(text)}</div>'
            f'<span class="label">{html.escape(label_a)}</span>'
            f'<audio controls preload="none" src="{html.escape(audio_a)}">'
            f'</audio>'
            f'<span class="label">{html.escape(label_b)}</span>'
            f'<audio controls preload="none" src="{html.escape(audio_b)}">'
            f'</audio></div>')


def make_multi_entry(text: str, audio_paths: Sequence[str],
                     labels: Optional[Sequence[str]] = None) -> str:
    labels = labels or [f"model {i}" for i in range(len(audio_paths))]
    rows = "".join(
        f'<span class="label">{html.escape(l)}</span>'
        f'<audio controls preload="none" src="{html.escape(p)}"></audio>'
        for p, l in zip(audio_paths, labels))
    return (f'<div class="entry"><div class="text">{html.escape(text)}</div>'
            f"{rows}</div>")


def build_page(entries: List[str], title: str = "TTS samples") -> str:
    body = "\n".join(entries)
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title><style>{_STYLE}</style>"
            f"</head><body><h1>{html.escape(title)}</h1>"
            f"<label>volume <input id='volume' type='range' min='0' max='1' "
            f"step='0.01' value='0.7'></label>\n{body}\n{_VOLUME_SCRIPT}"
            f"</body></html>")


def write_page(path, entries: List[str], title: str = "TTS samples"):
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(build_page(entries, title), encoding="utf-8")
    return p
