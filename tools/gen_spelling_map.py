#!/usr/bin/env python
"""Regenerate ssi_jax/eval/english_spelling.json (British->American mapping).

The reference normalizes WER text with whisper_normalizer's
EnglishTextNormalizer, whose ~1.7k-entry ``english.json`` asset (derived from
the public tysto UK/US spelling list) maps British spellings to American ones
(ref: scripts/wer.py:61-64). That asset is not on disk and the build
environment has no egress, so this tool reconstructs the mapping from first
principles: curated stem lists per morphological class, expanded into their
inflected forms, plus a hand-curated irregular table.

Classes generated:
  1. -ise -> -ize verbs (base/-d/-s/-ing, opt. agent -er/-ers, opt. -ation/s)
  2. -yse -> -yze verbs
  3. -our -> -or nouns and their derivatives
  4. -re  -> -er nouns (centre, litre, fibre ...)
  5. ae/oe -> e reductions (anaemia, oestrogen ...)
  6. doubled-l inflections (travelled -> traveled) and the reverse
     single-l stems (fulfil -> fulfill)
  7. -ence -> -ense nouns (defence -> defense)
  8. -ogue -> -og nouns
  9. irregulars (tyre, kerb, plough, cheque ...)

Every stem was checked against the rule "the American form actually differs"
(e.g. ``advertise``/``disenfranchise`` keep -ise in American English and are
deliberately absent). Entries already present in the committed JSON take
priority verbatim, so re-running this tool never changes shipped behavior for
previously-covered words; it only adds coverage.

Usage: python tools/gen_spelling_map.py [--check]
  --check: exit non-zero if the committed JSON differs from the generated one.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

OUT = Path(__file__).resolve().parent.parent / "ssi_jax" / "eval" / "english_spelling.json"

# --------------------------------------------------------------------------
# 1. -ise verbs: (stem, agent, ation). agent: also Xiser/Xisers;
#    ation: also Xisation/Xisations.
# --------------------------------------------------------------------------
ISE_STEMS: list[tuple[str, bool, bool]] = [
    ("accessor", False, False), ("acclimat", False, True), ("aggrand", False, True),
    ("agon", False, False), ("alphabet", False, True), ("amort", False, True),
    ("anglic", False, True), ("annual", False, True), ("antagon", False, False),
    ("antholog", False, False), ("apolog", False, False), ("apostroph", False, False),
    ("appet", True, False), ("atom", True, True), ("author", False, True),
    ("bapt", False, False), ("bastard", False, True), ("bowdler", False, True),
    ("brutal", False, True), ("burglar", False, False), ("canal", False, True),
    ("cannibal", False, True), ("canon", False, True), ("capital", False, True),
    ("caramel", False, True), ("carbon", False, True), ("categor", False, True),
    ("cauter", False, True), ("central", False, True), ("character", False, True),
    ("civil", False, True), ("collateral", False, True), ("colon", True, True),
    ("commercial", False, True), ("compartmental", False, True),
    ("computer", False, True), ("contextual", False, True), ("criminal", False, True),
    ("critic", False, False), ("crystall", False, True), ("custom", False, True),
    ("decentral", False, True), ("decimal", False, True), ("decolon", False, True),
    ("decriminal", False, True), ("dehuman", False, True), ("demilitar", False, True),
    ("demobil", False, True), ("democrat", False, True), ("demon", False, True),
    ("demoral", False, True), ("denational", False, True), ("deodor", True, True),
    ("depersonal", False, True), ("deput", False, False), ("desensit", False, True),
    ("destabil", False, True), ("digit", False, True), ("disorgan", False, True),
    ("dogmat", False, False), ("dramat", False, True), ("econom", False, False),
    ("editorial", False, True), ("empath", False, False), ("emphas", False, False),
    ("energ", True, False), ("epitom", False, False), ("equal", True, True),
    ("eulog", False, False), ("euthan", False, False), ("evangel", False, True),
    ("extempor", False, True), ("external", False, True), ("factor", False, True),
    ("familiar", False, True), ("fantas", False, False), ("federal", False, True),
    ("fertil", True, True), ("fictional", False, True), ("final", False, True),
    ("formal", False, True), ("fossil", False, True), ("fratern", False, True),
    ("galvan", False, True), ("general", False, True), ("ghetto", False, True),
    ("glamor", False, True), ("global", False, True), ("harmon", False, True),
    ("homogen", False, True), ("hospital", False, True), ("human", False, True),
    ("hybrid", False, True), ("hypnot", True, True), ("hypothes", False, False),
    ("ideal", False, True), ("idol", False, True), ("immobil", True, True),
    ("immortal", False, True), ("immun", False, True), ("impersonal", False, True),
    ("individual", False, True), ("industrial", False, True), ("initial", False, True),
    ("institutional", False, True), ("internal", False, True),
    ("international", False, True), ("ital", False, True), ("item", False, False),
    ("jeopard", False, False), ("journal", False, False), ("legal", False, True),
    ("legitim", False, True), ("liberal", False, True), ("lion", False, False),
    ("liquid", True, True), ("local", False, True), ("magnet", False, True),
    ("marginal", False, True), ("material", False, True), ("maxim", True, True),
    ("mechan", False, True), ("memorial", False, True), ("memor", False, True),
    ("mesmer", False, True), ("metabol", False, True), ("militar", False, True),
    ("miniatur", False, True), ("minim", True, True), ("mobil", False, True),
    ("modern", True, True), ("monopol", False, True), ("moral", False, True),
    ("mytholog", False, True), ("national", False, True),
    ("natural", False, True), ("neutral", True, True), ("normal", False, True),
    ("ostrac", False, False), ("oxid", False, True), ("particular", False, True),
    ("pasteur", False, True), ("patron", False, True), ("pedestrian", False, True),
    ("penal", False, True), ("personal", False, True), ("philosoph", True, False),
    ("plagiar", True, True), ("plural", False, True), ("polar", False, True),
    ("polit", False, True), ("popular", False, True), ("pressur", False, True),
    ("priorit", False, True), ("privat", False, True), ("problemat", False, True),
    ("professional", False, True), ("propagand", False, False),
    ("proselyt", True, False), ("public", False, False), ("pulver", False, True),
    ("radical", False, True), ("random", False, True), ("rational", False, True),
    ("real", False, True), ("recogn", False, False), ("regional", False, True),
    ("regular", False, True), ("reorgan", False, True), ("revital", False, True),
    ("revolution", False, True), ("rhapsod", False, False), ("ritual", False, True),
    ("roman", False, True), ("romantic", False, True), ("satir", False, True),
    ("scandal", False, True), ("scrutin", False, True), ("secular", False, True),
    ("sensational", False, True), ("sensit", False, True),
    ("sentimental", False, True), ("serial", False, True), ("sermon", False, False),
    ("sexual", False, True), ("social", False, True), ("solemn", False, True),
    ("special", False, True), ("stabil", True, True), ("standard", False, True),
    ("steril", True, True), ("stigmat", False, True), ("styl", False, True),
    ("subsid", False, True), ("summar", False, True), ("symbol", False, True),
    ("sympath", True, False), ("synchron", False, True), ("synthes", True, False),
    ("systemat", False, True), ("tantal", False, True), ("tender", True, True),
    ("terror", False, True), ("theor", False, True), ("total", False, True),
    ("traumat", False, True), ("trivial", False, True), ("tyrann", False, True),
    ("unauthor", False, True), ("union", False, True), ("urban", False, True),
    ("util", False, True), ("vandal", False, True), ("vapor", True, True),
    ("verbal", False, True), ("victim", False, True), ("visual", False, True),
    ("vocal", False, True), ("vulcan", False, True), ("vulgar", False, True),
    ("western", False, True), ("woman", True, True),
]

YSE_STEMS = ["anal", "catal", "dial", "electrol", "hydrol", "paral", "psychoanal", "reanal"]

# -our words: base + plural-ish derivative suffixes appended to the British form
# (the American form is the same suffix on the -or base).
OUR_WORDS: dict[str, list[str]] = {
    "arbour": ["s"],
    "ardour": [],
    "armour": ["ed", "er", "ers", "ies", "y"],
    "behaviour": ["al", "s"],
    "belabour": ["ed", "ing", "s"],
    "candour": [],
    "clamour": ["ed", "ing", "s"],
    "clangour": [],
    "colour": ["ant", "ants", "ed", "ful", "fully", "ing", "ings", "less", "s"],
    "demeanour": [],
    "discolour": ["ation", "ations", "ed", "ing", "s"],
    "dishonour": ["able", "ably", "ed", "ing", "s"],
    "endeavour": ["ed", "ing", "s"],
    "favour": ["able", "ably", "ed", "ing", "ite", "ites", "itism", "s"],
    "fervour": [],
    "flavour": ["ed", "ing", "ings", "less", "s", "some"],
    "glamour": [],
    "harbour": ["ed", "ing", "s"],
    "honour": ["able", "ably", "ed", "ing", "s"],
    "humour": ["ed", "ing", "less", "s"],
    "labour": ["ed", "er", "ers", "ing", "s"],
    "misbehaviour": [],
    "misdemeanour": ["s"],
    "multicolour": ["ed", "s"],
    "neighbour": ["hood", "hoods", "ing", "liness", "ly", "s"],
    "odour": ["less", "s"],
    "parlour": ["s"],
    "rancour": [],
    "rigour": ["s"],
    "rumour": ["ed", "ing", "s"],
    "saviour": ["s"],
    "savour": ["ed", "ies", "ing", "s", "y"],
    "splendour": ["s"],
    "succour": ["ed", "ing", "s"],
    "tumour": ["s"],
    "unfavour": ["able", "ably"],
    "unsavour": ["iness", "ily", "y"],
    "valour": [],
    "vapour": ["s"],
    "vigour": [],
    "watercolour": ["s"],
}

# -re -> -er (base + plural)
RE_WORDS = [
    "amphitheatre", "calibre", "centilitre", "centimetre", "centre", "epicentre",
    "fibre", "goitre", "kilolitre", "kilometre", "litre", "louvre", "lustre",
    "metre", "microlitre", "micrometre", "millilitre", "millimetre",
    "mitre", "nitre", "ochre", "philtre", "sabre", "saltpetre",
    "sceptre", "sepulchre", "spectre", "theatre", "titre",
]
# -re family forms whose American spelling needs more than the s-suffix rule
RE_EXTRA = {
    "centred": "centered", "centring": "centering",
    "fibreglass": "fiberglass",
    "lustreless": "lusterless",
    "meagre": "meager", "meagrely": "meagerly", "meagreness": "meagerness",
    "mitred": "mitered",
    "reconnoitre": "reconnoiter", "reconnoitred": "reconnoitered",
    "reconnoitres": "reconnoiters", "reconnoitring": "reconnoitering",
    "sombre": "somber", "sombrely": "somberly", "sombreness": "somberness",
    "theatregoer": "theatergoer", "theatregoers": "theatergoers",
}

# ae / oe -> e, applied as a literal substring replacement
AE_OE = [
    "aeon", "aeons", "aeroplane", "aeroplanes", "aesthete", "aesthetes",
    "aesthetic", "aesthetically", "aesthetics", "amoeba", "amoebae", "amoebas",
    "anaemia", "anaemic", "anaesthesia", "anaesthetic", "anaesthetics",
    "anaesthetist", "anaesthetists",
    "archaeological", "archaeologically", "archaeologist", "archaeologists",
    "archaeology", "caesarean", "caesareans", "caesium", "diarrhoea",
    "encyclopaedia", "encyclopaedias", "encyclopaedic", "faecal", "faeces",
    "foetal", "foetid", "foetus", "foetuses", "gonorrhoea", "gynaecological",
    "gynaecologist", "gynaecologists", "gynaecology", "haematology",
    "haemoglobin", "haemophilia", "haemophiliac", "haemophiliacs",
    "haemorrhage", "haemorrhaged", "haemorrhages", "haemorrhaging",
    "haemorrhoids", "leukaemia", "mediaeval",
    "oedema", "oesophagus", "oestrogen", "orthopaedic", "orthopaedics",
    "paediatric", "paediatrician", "paediatricians", "paediatrics",
    "palaeolithic", "palaeontologist", "palaeontologists", "palaeontology",
    "praesidium", "septicaemia", "synaesthesia",
]

# manoeuvre needs both oe->e and -re->-er; enumerate the family explicitly
MANOEUVRE = {
    "manoeuvrability": "maneuverability", "manoeuvrable": "maneuverable",
    "manoeuvre": "maneuver", "manoeuvred": "maneuvered",
    "manoeuvres": "maneuvers", "manoeuvring": "maneuvering",
    "manoeuvrings": "maneuverings", "outmanoeuvre": "outmaneuver",
    "outmanoeuvred": "outmaneuvered", "outmanoeuvres": "outmaneuvers",
    "outmanoeuvring": "outmaneuvering",
}

# British doubled-l inflections -> American single-l (drop one l at the last ll)
DOUBLE_L = [
    "barrelled", "barrelling", "bedevilled", "bedevilling", "bejewelled",
    "bevelled", "bevelling", "cancelled", "cancelling", "carolled", "carolling",
    "channelled", "channelling", "chiselled", "chiselling", "counselled",
    "counselling", "counsellor", "counsellors", "cudgelled", "cudgelling",
    "dialled", "dialling", "dishevelled", "drivelled", "drivelling", "duelled",
    "duelling", "enamelled", "enamelling", "equalled", "equalling",
    "fuelled", "fuelling", "funnelled", "funnelling", "gambolled", "gambolling",
    "gravelled", "grovelled", "groveller", "grovelling", "gruelling",
    "gruellingly", "imperilled", "initialled", "initialling", "jewelled",
    "jeweller", "jewellers", "jewellery", "kennelled", "kennelling", "labelled",
    "labelling", "levelled", "leveller", "levellers", "levelling",
    "libelled", "libelling", "libellous", "marshalled", "marshalling",
    "marvelled", "marvelling", "marvellous", "marvellously", "medallist",
    "medallists", "modelled", "modeller", "modellers", "modelling", "panelled",
    "panelling", "panellist", "panellists", "parcelled", "parcelling",
    "pedalled", "pedalling", "pencilled", "pencilling", "pummelled",
    "quarrelled", "quarrelling", "ravelled", "ravelling", "refuelled",
    "refuelling", "remodelled", "remodelling", "revelled", "reveller",
    "revellers", "revelling", "rivalled", "rivalling", "shovelled",
    "shovelling", "shrivelled", "shrivelling", "signalled", "signalling",
    "snivelled", "sniveller", "snivelling", "snorkelled", "snorkelling",
    "spiralled", "spiralling", "squirrelled", "stencilled", "stencilling",
    "swivelled", "swivelling", "tasselled", "teetotaller", "teetotallers",
    "towelled", "towelling", "trammelled", "travelled", "traveller",
    "travellers", "travelling", "tunnelled", "tunnelling", "unequalled",
    "unravelled", "unravelling", "unrivalled", "untrammelled", "woollen",
    "woollens", "yodelled", "yodeller", "yodelling",
]

# British single-l stems -> American double-l
SINGLE_L = {
    "appal": "appall", "appals": "appalls", "distil": "distill",
    "distils": "distills", "enrol": "enroll", "enrolment": "enrollment",
    "enrolments": "enrollments", "enrols": "enrolls", "enthral": "enthrall",
    "enthralment": "enthrallment", "enthrals": "enthralls", "fulfil": "fulfill",
    "fulfilment": "fulfillment", "fulfils": "fulfills", "instal": "install",
    "instalment": "installment", "instalments": "installments", "instals": "installs",
    "instil": "instill", "instils": "instills", "skilful": "skillful",
    "skilfully": "skillfully", "unskilful": "unskillful", "wilful": "willful",
    "wilfully": "willfully", "wilfulness": "willfulness",
}

ENCE = {
    "defence": "defense", "defenceless": "defenseless", "defences": "defenses",
    "licence": "license", "licences": "licenses", "offence": "offense",
    "offences": "offenses", "pretence": "pretense", "pretences": "pretenses",
}

OGUE = {
    "analogue": "analog", "analogues": "analogs", "catalogue": "catalog",
    "catalogued": "cataloged", "catalogues": "catalogs", "cataloguing": "cataloging",
    "dialogue": "dialog", "dialogues": "dialogs", "monologue": "monolog",
    "monologues": "monologs", "travelogue": "travelog", "travelogues": "travelogs",
}

IRREGULAR = {
    "aluminium": "aluminum", "annexe": "annex",
    "artefact": "artifact", "artefacts": "artifacts", "behove": "behoove",
    "behoves": "behooves", "carburettor": "carburetor", "carburettors": "carburetors",
    "cheque": "check", "chequebook": "checkbook", "chequebooks": "checkbooks",
    "chequered": "checkered", "cheques": "checks", "cosier": "cozier",
    "cosies": "cozies", "cosiest": "coziest", "cosily": "cozily",
    "cosiness": "coziness", "cosy": "cozy", "doughnut": "donut",
    "doughnuts": "donuts", "draught": "draft", "draughtier": "draftier",
    "draughtiest": "draftiest", "draughts": "drafts", "draughtsman": "draftsman",
    "draughtsmanship": "draftsmanship", "draughtsmen": "draftsmen",
    "draughty": "drafty", "gaol": "jail", "gaoled": "jailed", "gaoler": "jailer",
    "gaolers": "jailers", "gaoling": "jailing", "gaols": "jails",
    "gramme": "gram", "grammes": "grams", "grey": "gray", "greyed": "grayed",
    "greying": "graying", "greyish": "grayish", "greyness": "grayness",
    "greys": "grays", "kerb": "curb", "kerbs": "curbs", "kilogramme": "kilogram",
    "kilogrammes": "kilograms", "mould": "mold", "moulded": "molded",
    "moulder": "molder", "mouldered": "moldered", "mouldering": "moldering",
    "moulders": "molders", "mouldier": "moldier", "mouldiest": "moldiest",
    "moulding": "molding", "mouldings": "moldings", "moulds": "molds",
    "mouldy": "moldy", "moult": "molt", "moulted": "molted", "moulting": "molting",
    "moults": "molts", "moustache": "mustache", "moustached": "mustached",
    "moustaches": "mustaches", "pernickety": "persnickety", "phoney": "phony",
    "plough": "plow", "ploughed": "plowed", "ploughing": "plowing",
    "ploughman": "plowman", "ploughmen": "plowmen", "ploughs": "plows",
    "ploughshare": "plowshare", "ploughshares": "plowshares",
    "practise": "practice", "practised": "practiced", "practises": "practices",
    "practising": "practicing", "primaeval": "primeval", "pyjama": "pajama",
    "pyjamas": "pajamas", "sceptic": "skeptic", "sceptical": "skeptical",
    "sceptically": "skeptically", "scepticism": "skepticism",
    "sceptics": "skeptics", "smoulder": "smolder", "smouldered": "smoldered",
    "smouldering": "smoldering", "smoulders": "smolders",
    "snowplough": "snowplow", "snowploughs": "snowplows",
    "speciality": "specialty", "specialities": "specialties",
    "storey": "story", "storeys": "stories", "sulphate": "sulfate",
    "sulphates": "sulfates", "sulphide": "sulfide", "sulphides": "sulfides",
    "sulphur": "sulfur", "sulphurous": "sulfurous", "titbit": "tidbit",
    "titbits": "tidbits", "tyre": "tire", "tyres": "tires",
    "whisky": "whiskey",
    # colour + -ise composes both transforms; enumerate directly
    "colourise": "colorize", "colourised": "colorized",
    "colourises": "colorizes", "colourising": "colorizing",
    "colourisation": "colorization", "decolourise": "decolorize",
    "vapourise": "vaporize", "vapourised": "vaporized",
    "vapourises": "vaporizes", "vapourising": "vaporizing",
    "glamourise": "glamorize", "glamourised": "glamorized",
    "glamourises": "glamorizes", "glamourising": "glamorizing",
    # tranquill- : British double-l, American single-l + -ize
    "tranquillise": "tranquilize", "tranquillised": "tranquilized",
    "tranquilliser": "tranquilizer", "tranquillisers": "tranquilizers",
    "tranquillises": "tranquilizes", "tranquillising": "tranquilizing",
    "tranquillity": "tranquility",
}


def build() -> dict[str, str]:
    m: dict[str, str] = {}

    def put(brit: str, amer: str) -> None:
        if brit != amer:
            m[brit] = amer

    for stem, agent, ation in ISE_STEMS:
        for suf_b, suf_a in (("ise", "ize"), ("ised", "ized"), ("ises", "izes"), ("ising", "izing")):
            put(stem + suf_b, stem + suf_a)
        if agent:
            put(stem + "iser", stem + "izer")
            put(stem + "isers", stem + "izers")
        if ation:
            put(stem + "isation", stem + "ization")
            put(stem + "isations", stem + "izations")

    for stem in YSE_STEMS:
        for suf_b, suf_a in (("yse", "yze"), ("ysed", "yzed"), ("yses", "yzes"), ("ysing", "yzing")):
            put(stem + suf_b, stem + suf_a)

    for word, extras in OUR_WORDS.items():
        amer = word.replace("our", "or")
        put(word, amer)
        for suf in extras:
            put(word + suf, amer + suf)

    for word in RE_WORDS:
        amer = word[:-2] + "er"
        put(word, amer)
        put(word + "s", amer + "s")
    for b, a in RE_EXTRA.items():
        put(b, a)

    for word in AE_OE:
        put(word, word.replace("ae", "e").replace("oe", "e"))

    for word in DOUBLE_L:
        idx = word.rfind("ll")
        put(word, word[:idx] + word[idx + 1:])

    for table in (MANOEUVRE, SINGLE_L, ENCE, OGUE, IRREGULAR):
        for b, a in table.items():
            put(b, a)

    # Entries already shipped take absolute priority (frozen behavior).
    existing = json.loads(OUT.read_text()) if OUT.exists() else {}
    m.update(existing)
    return dict(sorted(m.items()))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    generated = build()
    if args.check:
        committed = json.loads(OUT.read_text())
        if committed != generated:
            raise SystemExit(
                f"english_spelling.json is stale: {len(committed)} committed vs {len(generated)} generated"
            )
        print(f"ok: {len(generated)} entries")
        return
    OUT.write_text(json.dumps(generated, indent=1, sort_keys=True) + "\n")
    print(f"wrote {len(generated)} entries to {OUT}")


if __name__ == "__main__":
    main()
