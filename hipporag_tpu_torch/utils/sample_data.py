"""Toy multi-hop corpus + queries for examples and integration runs of the
port (its copy of the JAX package's ``utils/sample_data.py``, so they need
nothing of that package).

The headline 2-hop case: "Mira Voss → Port Ellery → Calder County".
"""

corpus = [
    "Mira Voss is a marine biologist. Mira Voss was born in Port Ellery.",
    "Port Ellery is a coastal town. Port Ellery is located in Calder County.",
    "Calder County is a county in the state of Veridia. Calder County is known for its fishing fleet.",
    "Aldous Finch composed the opera The Glass Harbor in 1921. Aldous Finch was born in Southgate City.",
    "The Glass Harbor is an opera. The Glass Harbor premiered at the Meridian Theatre.",
    "Southgate City is the capital of the province of Arden. Southgate City lies on the Brennan River.",
    "Tessa Kincaid wrote the novel Winter of the Lighthouse. Tessa Kincaid lives in Port Ellery.",
    "The Meridian Theatre is a historic opera house. The Meridian Theatre is located in Southgate City.",
    "The Brennan River flows through the province of Arden. The Brennan River empties into the Sea of Veridia.",
]

all_queries = [
    "In which county was Mira Voss born?",
    "Which city is home to the theatre where The Glass Harbor premiered?",
    "Which river flows through the province whose capital is Southgate City?",
]

gold_answers = [
    ["Calder County"],
    ["Southgate City"],
    ["Brennan River", "The Brennan River"],
]
